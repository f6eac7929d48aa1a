"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with nvcc for
``sm_90a`` into its own shared library, loaded with ctypes. Nothing is
built at import: the first wrapper call that needs a kernel (or an
explicit :func:`build_all`) compiles every source at once, one nvcc per
file, all started together. Libraries go under
``build/hyperspace_tpu_torch/<hash of the sources and flags>/`` beside
the package, so a changed source never loads a stale library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel's C entry returned a CUDA error code (every wrapper in
    ``ops/`` raises this one), or, where a wrapper reads its kernel's
    output back (``ops/bloom.to_host``), the kernel faulted while it ran."""


#: the faults of a hand-written kernel: the optimizer re-raises them
#: rather than serving the plan without its rewrite (``rules/apply.py``)
KERNEL_FAULTS = (KernelBuildError, KernelLaunchError)


def sources() -> List[str]:
    return sorted(
        os.path.join(CSRC_DIR, f)
        for f in os.listdir(CSRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    root = os.path.join(os.path.dirname(_PKG_DIR), "build", "hyperspace_tpu_torch")
    return os.path.join(root, h.hexdigest()[:16])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def build_all() -> str:
    """Compile every ``csrc/*.cu`` not yet built for the current sources,
    in parallel; returns the build directory. Raises
    :class:`KernelBuildError` with nvcc's output on any failure."""
    out_dir = build_dir()
    todo = [
        s
        for s in sources()
        if s.endswith(".cu") and not os.path.exists(_lib_path(out_dir, s))
    ]
    if not todo:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        final = _lib_path(out_dir, src)
        tmp = f"{final}.tmp.{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src]
        procs.append(
            (src, final, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    failed = []
    for src, final, tmp, proc in procs:
        log, _ = proc.communicate()
        with open(final[: -len(".so")] + ".log", "w") as fh:
            fh.write(log)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{log}")
            continue
        os.replace(tmp, final)
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return out_dir


def _lib_path(out_dir: str, src: str) -> str:
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(out_dir, f"lib{name}.so")


def load(name: str) -> ctypes.CDLL:
    """The ctypes library built from ``csrc/<name>.cu`` (building every
    kernel first if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    # Lock-held I/O by design: the lock serialises one build a process
    # (nvcc runs once, every waiting thread then loads its result); the
    # lock-free ``_libs`` read above keeps launches off it.
    with _lock:  # hslint: disable=HS502
        lib = _libs.get(name)
        if lib is None:
            out_dir = build_all()
            lib = ctypes.CDLL(_lib_path(out_dir, os.path.join(CSRC_DIR, name + ".cu")))
            _libs[name] = lib
    return lib
