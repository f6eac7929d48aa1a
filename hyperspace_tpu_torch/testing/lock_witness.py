"""Runtime lock witness: record what the lock model ACTUALLY does.

The HS5xx/HS6xx checkers reason about a *static* lock model — which
locks exist, which guard what (``SHARED_STATE``), which acquisition
edges are possible. A static model rots silently: a new code path can
take locks the analyzer cannot resolve, and then every cycle/guard
verdict is built on sand. This module closes the loop dynamically:

* :func:`install` wraps every lock named in ``SHARED_STATE``
  (``hyperspace_tpu_torch/concurrency.py``) — module-level locks by attribute
  replacement, instance locks by hooking the owning class's
  ``__init__`` — with a recording proxy;
* while the stress / frontend suites run, the proxy records per-lock
  acquisition counts and the observed acquisition EDGES (lock B taken
  while A is held, per thread);
* :func:`dump` writes (merging with any prior artifact) a JSON witness:
  ``{"locks": {name: count}, "edges": [[a, b, count]…],
  "entries": {state: {"lock": name, "policy": …}}}``, lock names in the
  same canonical ``<rel>::<attr>`` / ``<rel>::<Class>.<attr>`` form the
  static model uses (``analysis/locks.canonical_lock_name``);
* ``hslint --witness <artifact>`` cross-checks
  (``analysis/shared_state.witness_cross_check``): a witnessed edge or
  lock the static graph lacks is a hard model-gap error; a static edge
  never witnessed is a staleness warning.

Counterpart of ``hyperspace_tpu/testing/lock_witness.py`` over the
port's ``SHARED_STATE``; the artifact has the reference's format. A
caller arms it with :func:`install` before the instances under test are
built (``tests/test_torch_witnesses.py``).

Overhead is one thread-local list append per acquisition — fine for
tests, not meant for production serving. Stdlib-only, like everything
in ``testing/``.
"""

from __future__ import annotations

import importlib
import os
import threading
from typing import Dict, List, Optional, Tuple

_PKG = "hyperspace_tpu_torch"

_rec_lock = threading.Lock()
_acquires: Dict[str, int] = {}
_edges: Dict[Tuple[str, str], int] = {}
_tls = threading.local()

_installed: Dict[str, "_WitnessLock"] = {}  # canonical name -> wrapper
_module_patches: List[Tuple[object, str, object]] = []  # (module, attr, orig)
_class_patches: List[Tuple[type, object]] = []  # (cls, orig __init__)


def _held_stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _WitnessLock:
    """Recording proxy around a ``threading.Lock``/``RLock``. Supports
    the full acquire/release + context-manager protocol the package
    uses (including ``acquire(blocking=False)``)."""

    def __init__(self, inner, name: str):
        self._inner = inner
        self.witness_name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._record_acquire()
        return got

    def release(self):
        self._inner.release()
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.witness_name:
                del stack[i]
                break

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self._inner.acquire()
        self._record_acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def _record_acquire(self) -> None:
        stack = _held_stack()
        with _rec_lock:
            _acquires[self.witness_name] = (
                _acquires.get(self.witness_name, 0) + 1
            )
            for held in stack:
                if held != self.witness_name:  # RLock re-entry is not an edge
                    edge = (held, self.witness_name)
                    _edges[edge] = _edges.get(edge, 0) + 1
        stack.append(self.witness_name)


# ---------------------------------------------------------------------------
# Registry resolution
# ---------------------------------------------------------------------------


def _module_rel(module) -> str:
    """'io/scan.py'-style path of a loaded module, relative to the
    package root — matches ``analysis/core.Project`` rel paths."""
    pkg = importlib.import_module(_PKG)
    root = os.path.dirname(os.path.abspath(pkg.__file__))
    return os.path.relpath(os.path.abspath(module.__file__), root).replace(
        os.sep, "/"
    )


def _resolve_module_lock(spec: str):
    """(module, attr) for a dotted module-lock spec, importing the
    module. Raises on a stale spec — the witness must never silently
    watch nothing."""
    mod_name, _, attr = spec.rpartition(".")
    module = importlib.import_module(mod_name)
    if not hasattr(module, attr):
        raise AttributeError(f"lock {spec!r} not found")
    return module, attr


def _resolve_class(state_path: str):
    """(class, class name, module) for a registered class-attr state
    path like ``pkg.mod.Class.attr``."""
    mod_name, _, _attr = state_path.rpartition(".")
    cls_mod, _, cls_name = mod_name.rpartition(".")
    module = importlib.import_module(cls_mod)
    return getattr(module, cls_name), cls_name, module


def install() -> Dict[str, str]:
    """Wrap every SHARED_STATE-declared lock; idempotent. Returns
    {registry state path -> canonical lock name} for the wrapped ones.
    Must run before the instances under test are constructed — instance
    locks are wrapped at ``__init__`` time."""
    from hyperspace_tpu_torch.concurrency import SHARED_STATE

    wrapped: Dict[str, str] = {}
    for state_path, (lock_spec, _policy, _why) in SHARED_STATE.items():
        if not lock_spec:
            continue
        if lock_spec.startswith("self."):
            attr = lock_spec[len("self.") :]
            cls, cls_name, module = _resolve_class(state_path)
            name = f"{_module_rel(module)}::{cls_name}.{attr}"
            wrapped[state_path] = name
            if name in _installed:
                continue
            _installed[name] = _hook_class(cls, attr, name)
        else:
            module, attr = _resolve_module_lock(lock_spec)
            name = f"{_module_rel(module)}::{attr}"
            wrapped[state_path] = name
            if name in _installed:
                continue
            orig = getattr(module, attr)
            if isinstance(orig, _WitnessLock):
                _installed[name] = orig
                continue
            proxy = _WitnessLock(orig, name)
            _module_patches.append((module, attr, orig))
            setattr(module, attr, proxy)
            _installed[name] = proxy
    return wrapped


def _hook_class(cls: type, attr: str, name: str) -> "_WitnessLock":
    """Patch ``cls.__init__`` to wrap ``self.<attr>`` right after
    construction. Returns a placeholder proxy (per-instance proxies are
    created at init time; they all share the canonical name)."""
    orig_init = cls.__init__

    def init(self, *args, **kwargs):
        orig_init(self, *args, **kwargs)
        inner = getattr(self, attr, None)
        if inner is not None and not isinstance(inner, _WitnessLock):
            setattr(self, attr, _WitnessLock(inner, name))

    _class_patches.append((cls, orig_init))
    cls.__init__ = init
    return _WitnessLock(threading.Lock(), name)


def uninstall() -> None:
    """Restore patched module attributes and class __init__s (existing
    wrapped instances keep their proxies — harmless pass-throughs)."""
    while _module_patches:
        module, attr, orig = _module_patches.pop()
        setattr(module, attr, orig)
    while _class_patches:
        cls, orig_init = _class_patches.pop()
        cls.__init__ = orig_init
    _installed.clear()


def reset() -> None:
    """Zero the recorded counts/edges (artifact isolation in tests)."""
    with _rec_lock:
        _acquires.clear()
        _edges.clear()


def snapshot() -> dict:
    """The witness document for what has been recorded so far."""
    from hyperspace_tpu_torch.concurrency import SHARED_STATE

    entries = {}
    for state_path, (lock_spec, policy, _why) in SHARED_STATE.items():
        meta: dict = {"policy": policy}
        if lock_spec:
            if lock_spec.startswith("self."):
                try:
                    cls, cls_name, module = _resolve_class(state_path)
                    attr = lock_spec[len("self.") :]
                    meta["lock"] = f"{_module_rel(module)}::{cls_name}.{attr}"
                except Exception:  # hslint: disable=HS402
                    # a stale registry entry is HS603's finding to make,
                    # not a reason to lose the whole artifact
                    meta["lock"] = None
            else:
                try:
                    module, attr = _resolve_module_lock(lock_spec)
                    meta["lock"] = f"{_module_rel(module)}::{attr}"
                except Exception:  # hslint: disable=HS402
                    # same contract as above: record None, let hslint judge
                    meta["lock"] = None
        entries[state_path] = meta
    with _rec_lock:
        return {
            "version": 1,
            "package": _PKG,
            "locks": dict(_acquires),
            "edges": sorted(
                [a, b, n] for (a, b), n in _edges.items()
            ),
            "entries": entries,
        }


def dump(path: str, merge: bool = True) -> dict:
    """Write the witness artifact, summing counts with any existing one
    at ``path`` (several suites can accumulate into one artifact), via
    the shared temp + fsync + atomic-replace publish helper
    (``testing/artifacts.py`` — the ``calibrate._store_cache`` pattern,
    also used by the collective witness). Returns the document."""
    from hyperspace_tpu_torch.testing import artifacts

    doc = snapshot()
    prev = artifacts.load_json(path) if merge else None
    if prev is not None:
        artifacts.merge_count_maps(doc["locks"], prev.get("locks", {}))
        merged: Dict[Tuple[str, str], int] = {
            (a, b): n for a, b, n in doc["edges"]
        }
        artifacts.merge_count_maps(
            merged, {(a, b): n for a, b, n in prev.get("edges", [])}
        )
        doc["edges"] = sorted([a, b, n] for (a, b), n in merged.items())
        for state, meta in prev.get("entries", {}).items():
            doc["entries"].setdefault(state, meta)
    artifacts.atomic_write_json(path, doc)
    return doc
