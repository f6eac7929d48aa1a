"""Filesystem helpers used by the metadata plane.

Reference: ``util/FileUtils.scala`` (create/delete/read through the Hadoop
``FileSystem`` API). This build targets a POSIX filesystem (and, by
extension, FUSE-mounted object stores); the one primitive whose semantics
matter is *atomic create-if-absent*, used by the operation log's optimistic
concurrency (``index/IndexLogManager.scala:178-194``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List, Tuple


def write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


def read_text(path: str) -> str:
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY: durably record its entries.

    File fsync alone does not survive a dirent-loss crash on ext4 — the
    journal can commit the file's data while the directory entry that
    names it is still only in memory, so a crash right after an atomic
    publish can un-publish the name. Called after every link/replace
    that publishes a log entry. Best-effort: some filesystems (FUSE
    object-store mounts) reject directory fsync — there the rename
    itself is the durability point and this is a no-op."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_if_absent(path: str, text: str) -> bool:
    """Create ``path`` with ``text`` iff it does not exist; atomic.

    Mirrors the reference's temp-file + rename-without-overwrite protocol
    (``IndexLogManagerImpl.writeLog:178-194``): write to a temp file in the
    same directory, then ``os.link`` it to the final name. ``link`` fails
    with EEXIST if another writer won the race — the optimistic-concurrency
    conflict signal. Returns True on success, False on conflict.

    On object stores this maps to a generation-match precondition
    (if-generation-match=0 on GCS); the boolean contract is identical.
    FUSE mounts that don't support hard links fall back to exclusive
    create (O_EXCL), which those mounts do honor.
    """
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_log_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            # fsync BEFORE the link publishes the name: on a journaled filesystem a crash between write and
            # publish must never leave a torn/empty log entry visible
            # under its final name — readers treat an existing entry as
            # complete JSON (get_log has no partial-read recovery).
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            fsync_dir(d)
            return True
        except FileExistsError:
            return False
        except OSError:
            # Hard links unsupported (FUSE object-store mounts): O_EXCL path.
            # No atomic-content guarantee exists here at all (the name is
            # visible while the content streams); fsync at least bounds
            # the crash window to the write itself on those mounts.
            try:
                with open(path, "x", encoding="utf-8") as f:
                    f.write(text)
                    f.flush()
                    os.fsync(f.fileno())
                fsync_dir(d)
                return True
            except FileExistsError:
                return False
    finally:
        os.unlink(tmp)


def atomic_overwrite(path: str, text: str) -> None:
    """Atomically replace ``path`` with ``text`` (latestStable pointer).

    fsync-before-replace, like :func:`atomic_write_if_absent`: a crash
    right after the rename must not publish an empty pointer file (the
    rename can be journaled before the data on ext4/xfs without it).
    """
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_log_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def atomic_overwrite_bytes(path: str, data: bytes) -> None:
    """:func:`atomic_overwrite` for binary payloads (the serve cache's
    spill files): the same fsync-before-replace discipline, so a reader
    sees the complete payload under the final name or no file at all. A
    writer that dies mid-write leaves a ``.tmp_spool_`` temp, which
    recovery's spill reaper deletes once it has aged."""
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp_spool_")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except FileNotFoundError:
            pass
        raise


def delete(path: str) -> None:
    """Recursive delete, ignore-missing (FileUtils.delete)."""
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path, ignore_errors=True)
    else:
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass


def list_leaf_files(
    root: str, suffix: str = "", data_only: bool = False
) -> List[Tuple[str, int, int]]:
    """Recursive listing of (path, size, mtime_ms) for all regular files.

    Equivalent to the recursive ``listStatus`` in
    ``Content.fromDirectory`` (IndexLogEntry.scala:86-96). With
    ``data_only`` the walk skips hidden/metadata paths the way Spark's
    ``DataPathFilter`` does (``util/PathUtils.scala``); ``suffix`` filters
    by file extension. This is the single walker — callers must not grow
    their own ``os.walk`` so the hidden-path policy stays in one place.
    """
    from hyperspace_tpu_torch.utils.paths import is_data_path

    out: List[Tuple[str, int, int]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        if data_only:
            dirnames[:] = [d for d in dirnames if is_data_path(d)]
        for name in sorted(filenames):
            if suffix and not name.endswith(suffix):
                continue
            if data_only and not is_data_path(name):
                continue
            p = os.path.join(dirpath, name)
            try:
                st = os.stat(p)
            except FileNotFoundError:
                continue
            out.append((p, st.st_size, int(st.st_mtime * 1000)))
    return out


def dir_size(root: str) -> int:
    return sum(size for _p, size, _m in list_leaf_files(root))
