"""The PyTorch port stands alone: no module of hyperspace_tpu_torch (nor
chip_smoke.py, nor scripts/torch_*.py, nor the lake builders
tests/torch_lake.py that chip_smoke.py imports) imports JAX or the JAX package,
and a session never runs on the CPU unless the caller asks for it."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hyperspace_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "hyperspace_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"), os.path.join(ROOT, "tests", "torch_lake.py")]
    scripts = os.path.join(ROOT, "scripts")
    out += [
        os.path.join(scripts, f)
        for f in os.listdir(scripts)
        if f.startswith("torch_") and f.endswith(".py")
    ]
    for dirpath, _dirs, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_statement_names_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_forbidden_pattern_does_not_match_the_port():
    assert _forbidden("hyperspace_tpu.ops.hash") and _forbidden("jax.numpy")
    assert not _forbidden("hyperspace_tpu_torch.ops.hash")


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hyperspace_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'hyperspace_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'jaxlib')\n"
        "             or k.startswith(('jax.', 'jaxlib.', 'hyperspace_tpu.'))\n"
        "             or k == 'hyperspace_tpu')\n"
        "print(len([k for k in sys.modules if k.startswith('hyperspace_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 30


def test_session_without_cuda_and_without_device_raises(monkeypatch):
    from hyperspace_tpu_torch import HyperspaceException, HyperspaceSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(HyperspaceException, match="device='cpu'"):
        HyperspaceSession()
    with pytest.raises(HyperspaceException):
        HyperspaceSession(device="cuda")


def test_session_on_request_runs_on_the_cpu():
    from hyperspace_tpu_torch import HyperspaceSession

    assert HyperspaceSession(device="cpu").device == torch.device("cpu")
    with pytest.raises(Exception):
        HyperspaceSession(device="meta")
