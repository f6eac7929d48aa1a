"""An index directory's files and log entries in the form the lifecycle
comparisons hold equal: the CPU differentials (``tests/torch_lifecycle_twin.py``),
the card's cases in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``'s
phase 12. Imports neither JAX nor either package.

* Index files are compared byte for byte, the JSON sidecars
  (``_zonemaps.json``, ``_aggstate.json``) as parsed docs without their
  files' ``mtime_ns``, which each side's own writes set.
* Log entries are compared without the entry's id and timestamp, without
  the index files' ``modifiedTime``, with the directory names of the
  system path replaced by ``<sys>``, and with a begin entry's writer lease
  (a random owner and a time) compared by its presence.
"""

import json
import os

#: the index's log directory, left out of :func:`index_paths`
LOG_DIR = "_hyperspace_log"
#: the writer lease a begin entry carries while crash recovery is on
LEASE_PROPS = ("recovery.leaseOwner", "recovery.leaseExpiresAtMs")
#: sidecars compared as JSON without their files' mtime_ns
JSON_SIDECARS = ("_zonemaps.json", "_aggstate.json")


def index_paths(root: str) -> list:
    """The relative paths of every file under the index dir ``root`` but
    its log, sorted."""
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != LOG_DIR]
        out += [os.path.relpath(os.path.join(d, f), root) for f in files]
    return sorted(out)


def index_file(path: str):
    """A file's bytes; a JSON sidecar as its doc without the files'
    mtime_ns."""
    with open(path, "rb") as fh:
        data = fh.read()
    if os.path.basename(path) in JSON_SIDECARS:
        data = json.loads(data)
        for e in data["files"].values():
            e.pop("mtime_ns", None)
    return data


def index_files(root: str) -> dict:
    """Relative path -> :func:`index_file` of every file under ``root``
    but its log."""
    return {rel: index_file(os.path.join(root, rel)) for rel in index_paths(root)}


def read_log(root: str) -> dict:
    """File name -> parsed entry of every file in the index's log
    (numbered entries and ``latestStable``)."""
    log_dir = os.path.join(root, LOG_DIR)
    out = {}
    for f in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, f)) as fh:
            out[f] = json.load(fh)
    return out


def normalized_entry(entry: dict, sys_path: str) -> dict:
    """The entry without its id and timestamp and without the index files'
    mtimes, the system path's directory names replaced, and the writer
    lease's two values (a random owner, a time) replaced by placeholders,
    so entries compare by the lease's presence."""
    entry = dict(entry)
    entry.pop("id", None)
    entry.pop("timestamp", None)
    props = dict(entry.get("properties", {}))
    for p in LEASE_PROPS:
        if p in props:
            props[p] = f"<{p}>"
    entry["properties"] = props

    def drop_mtimes(x):
        if isinstance(x, dict):
            return {k: drop_mtimes(v) for k, v in x.items() if k != "modifiedTime"}
        if isinstance(x, list):
            return [drop_mtimes(v) for v in x]
        return x

    entry["content"] = drop_mtimes(entry["content"])
    text = json.dumps(entry, sort_keys=True)
    for part in sys_path.strip("/").split("/"):
        text = text.replace(f'"name": "{part}"', '"name": "<sys>"')
    return json.loads(text)


def normalized_log(root: str, sys_path: str) -> dict:
    """File name -> :func:`normalized_entry` of the index's log."""
    return {f: normalized_entry(e, sys_path) for f, e in read_log(root).items()}
