"""Runtime residency witness: record what ALLOC_SITES actually resides.

The HS10xx checker reasons about a *static* memory model — which
hot-path functions materialize row-proportional state, and which bound
class keeps each finite (``ALLOC_SITES``, ``hyperspace_tpu_torch/memory.py``).
A static model rots silently: a declared "chunk-bounded" site can start
returning whole relations and every residency verdict is built on sand.
This module closes the loop dynamically, the lock/collective-witness
doctrine applied to bytes:

* :func:`install` wraps every function/method named in ``ALLOC_SITES``
  — module-level functions by attribute replacement (including stale
  ``from x import f`` references in already-imported package modules),
  methods by replacing the class attribute — with a recording proxy;
* each call records the site's call count and the peak resident-byte
  estimate of what it returned, sized with the SAME ruler the cache
  governor uses (``execution/serve_cache.estimate_nbytes``), so the
  witness and the byte ledgers cannot disagree about what a value
  weighs; a torch tensor weighs ``numel() * element_size()``
  (:func:`value_nbytes`);
* :func:`dump` writes (merging with any prior artifact) a JSON witness:
  ``{"sites": {path: {"peak_bytes": n, "calls": n}},
  "budgets": {bound class: ceiling}, "rss_high_water": n}`` — budgets
  are stamped from ``memory.BOUND_CLASS_CEILINGS`` at runtime so the
  analyzer stays non-importing;
* ``hslint --witness <artifact>`` cross-checks
  (``analysis/residency.witness_cross_check``): a witnessed site the
  registry lacks is a hard model-gap error (HS1004), as is an observed
  peak past the site's declared bound-class ceiling; a declared site
  never witnessed is a staleness warning.

Counterpart of ``hyperspace_tpu/testing/residency_witness.py`` over the
port's ``ALLOC_SITES``; the artifact has the reference's format. A caller
arms it with :func:`install` before the calls under test
(``tests/test_torch_witnesses.py``).

Overhead is one size estimate per wrapped call — fine for tests and
bench rungs, not meant for production serving. The size estimate sees
the value a site RETURNS (the materialization that escapes the site);
transient internals are covered by the process RSS high-water mark
recorded alongside (``/proc/self/status`` VmHWM, getrusage fallback).
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

_PKG = "hyperspace_tpu_torch"

_rec_lock = threading.Lock()
_sites: Dict[str, Dict[str, int]] = {}  # site -> {"peak_bytes", "calls"}

_installed: Dict[str, bool] = {}  # site path -> wrapped
_module_patches: List[Tuple[object, str, object]] = []  # (module, attr, orig)
_class_patches: List[Tuple[type, str, object]] = []  # (cls, attr, orig)


def rss_high_water_bytes() -> int:
    """Process resident-set high-water mark in bytes. Linux reads
    ``VmHWM`` from ``/proc/self/status``; elsewhere falls back to
    ``getrusage(RUSAGE_SELF).ru_maxrss`` (kilobytes on Linux). 0 when
    neither source exists — the witness records what it can."""
    try:
        with open("/proc/self/status", "r", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
    except (ImportError, ValueError, OSError):
        return 0


def _record(site: str, nbytes: int) -> None:
    with _rec_lock:
        rec = _sites.get(site)
        if rec is None:
            rec = _sites[site] = {"peak_bytes": 0, "calls": 0}
        rec["calls"] += 1
        if nbytes > rec["peak_bytes"]:
            rec["peak_bytes"] = nbytes


def value_nbytes(value) -> int:
    """The bytes the witness charges a returned value: a torch tensor's
    ``numel() * element_size()``, anything else by the serve cache's own
    ruler (``execution/serve_cache.estimate_nbytes``)."""
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return int(value.numel()) * int(value.element_size())
    from hyperspace_tpu_torch.execution.serve_cache import estimate_nbytes

    return estimate_nbytes(value)


def _make_wrapper(orig, site: str):
    def wrapper(*args, **kwargs):
        result = orig(*args, **kwargs)
        _record(site, value_nbytes(result))
        return result

    wrapper.__name__ = getattr(orig, "__name__", site.rpartition(".")[2])
    wrapper.__doc__ = getattr(orig, "__doc__", None)
    wrapper.__wrapped__ = orig  # uninstall + idempotence marker
    wrapper.__hs_residency_site__ = site
    return wrapper


def _resolve_site(path: str):
    """('module', module, attr) or ('class', cls, attr) for a registered
    dotted site path; None for a module-level (import-time) entry or a
    path whose module cannot be imported in this environment."""
    mod_name, _, attr = path.rpartition(".")
    try:
        module = importlib.import_module(mod_name)
        return ("module", module, attr)
    except ImportError:
        pass
    cls_mod, _, cls_name = mod_name.rpartition(".")
    try:
        module = importlib.import_module(cls_mod)
    except ImportError:
        return None
    cls = getattr(module, cls_name, None)
    if isinstance(cls, type):
        return ("class", cls, attr)
    return None


def _patch_module_function(module, attr: str, site: str) -> bool:
    orig = getattr(module, attr, None)
    if orig is None or not callable(orig):
        return False
    if getattr(orig, "__hs_residency_site__", None) == site:
        return True  # already wrapped (idempotent install)
    wrapper = _make_wrapper(orig, site)
    _module_patches.append((module, attr, orig))
    setattr(module, attr, wrapper)
    # `from x import f` copies the reference: patch every already-loaded
    # package module holding the same function object, or those callers
    # would silently bypass the witness
    for name, mod in list(sys.modules.items()):
        if mod is None or mod is module or not name.startswith(_PKG):
            continue
        for alias, val in list(getattr(mod, "__dict__", {}).items()):
            if val is orig:
                _module_patches.append((mod, alias, orig))
                setattr(mod, alias, wrapper)
    return True


def _patch_method(cls: type, attr: str, site: str) -> bool:
    raw = cls.__dict__.get(attr)
    if raw is None:
        return False
    if isinstance(raw, classmethod):
        orig = raw.__func__
        if getattr(orig, "__hs_residency_site__", None) == site:
            return True
        wrapped: object = classmethod(_make_wrapper(orig, site))
    elif isinstance(raw, staticmethod):
        orig = raw.__func__
        if getattr(orig, "__hs_residency_site__", None) == site:
            return True
        wrapped = staticmethod(_make_wrapper(orig, site))
    elif callable(raw):
        if getattr(raw, "__hs_residency_site__", None) == site:
            return True
        wrapped = _make_wrapper(raw, site)
    else:
        return False  # property / descriptor sites are not wrappable
    _class_patches.append((cls, attr, raw))
    setattr(cls, attr, wrapped)
    return True


def install() -> Dict[str, bool]:
    """Wrap every ALLOC_SITES-declared function/method; idempotent.
    Returns {site path -> wrapped} (False = unresolvable here, e.g. a
    module-level entry; HS1003 owns truly stale paths). Must run before
    the calls under test — callers that already bound a reference via
    ``from x import f`` are re-pointed for loaded modules only."""
    from hyperspace_tpu_torch.memory import ALLOC_SITES

    out: Dict[str, bool] = {}
    for site in ALLOC_SITES:
        if site in _installed:
            out[site] = _installed[site]
            continue
        resolved = _resolve_site(site)
        ok = False
        if resolved is not None:
            kind, owner, attr = resolved
            if kind == "module":
                ok = _patch_module_function(owner, attr, site)
            else:
                ok = _patch_method(owner, attr, site)
        _installed[site] = ok
        out[site] = ok
    return out


def uninstall() -> None:
    """Restore patched module attributes and class methods."""
    while _class_patches:
        cls, attr, raw = _class_patches.pop()
        setattr(cls, attr, raw)
    while _module_patches:
        module, attr, orig = _module_patches.pop()
        setattr(module, attr, orig)
    _installed.clear()


def reset() -> None:
    """Zero the recorded per-site peaks/counts (artifact isolation)."""
    with _rec_lock:
        _sites.clear()


def snapshot() -> dict:
    """The witness document for what has been recorded so far. Budgets
    (the per-bound-class byte ceilings) are stamped here from
    ``memory.BOUND_CLASS_CEILINGS`` so the static cross-check never has
    to import the package."""
    from hyperspace_tpu_torch.memory import BOUND_CLASS_CEILINGS

    with _rec_lock:
        sites = {k: dict(v) for k, v in _sites.items()}
    return {
        "version": 1,
        "package": _PKG,
        "sites": sites,
        "budgets": dict(BOUND_CLASS_CEILINGS),
        "rss_high_water": rss_high_water_bytes(),
    }


def dump(path: str, merge: bool = True) -> dict:
    """Write the witness artifact via the shared temp + fsync +
    atomic-replace publish helper (``testing/artifacts.py``), merging
    with any existing artifact at ``path``: peaks and the RSS high-water
    take the max, call counts sum — several suites/rungs accumulate into
    one artifact, like the lock witness. Returns the document."""
    from hyperspace_tpu_torch.testing import artifacts

    doc = snapshot()
    prev = artifacts.load_json(path) if merge else None
    if isinstance(prev, dict):
        for site, rec in prev.get("sites", {}).items():
            if not isinstance(rec, dict):
                continue
            cur = doc["sites"].setdefault(
                site, {"peak_bytes": 0, "calls": 0}
            )
            cur["calls"] += int(rec.get("calls", 0))
            cur["peak_bytes"] = max(
                cur["peak_bytes"], int(rec.get("peak_bytes", 0))
            )
        doc["rss_high_water"] = max(
            doc["rss_high_water"], int(prev.get("rss_high_water", 0))
        )
    artifacts.atomic_write_json(path, doc)
    return doc
