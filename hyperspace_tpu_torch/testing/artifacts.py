"""Witness-artifact plumbing shared by the runtime witnesses.

The lock witness (``testing/lock_witness.py``) and the collective
witness (``testing/collective_witness.py``) both publish JSON artifacts
that ``hslint --witness`` later consumes, and both need the same two
pieces:

* :func:`atomic_write_json` — the ``calibrate._store_cache`` publish
  pattern (pid-qualified temp, fsync, ``os.replace``): a reader — or a
  crash — must never observe a torn artifact, and concurrent writers
  must never clobber each other's temp file;
* :func:`merge_count_maps` — summing ``{key: count}`` maps so several
  suites (or several dumps from one process) can accumulate into one
  artifact.

Stdlib-only, like everything in ``testing/``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional


def atomic_write_json(path: str, doc: dict) -> None:
    """Publish ``doc`` at ``path`` via temp + fsync + atomic replace."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_json(path: str) -> Optional[dict]:
    """The JSON dict at ``path``, or None when absent/unreadable/torn —
    merge callers treat a bad prior artifact as 'nothing to merge'."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def merge_count_maps(base: Dict, extra: Dict) -> Dict:
    """``base`` updated in place with ``extra``'s counts summed in."""
    for key, n in extra.items():
        base[key] = base.get(key, 0) + n
    return base
