"""Kernel B1 (murmur3 bucket ids) of the PyTorch port against the JAX
package: the plain PyTorch version must equal the numpy twin, the XLA
program and the Pallas kernel (interpret mode) bit for bit. The CUDA
kernel itself runs only on the card; chip_smoke.py holds it against the
plain version there."""

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.hash import (
    _PALLAS_BLOCK_N,
    _bucket_ids_words,
    bucket_ids_numpy,
    bucket_ids_pallas,
    split_words_np,
)
from hyperspace_tpu_torch import kernels
from hyperspace_tpu_torch import ops as port_ops
from hyperspace_tpu_torch.ops import hash as H

_I64 = np.iinfo(np.int64)


def _reps(k: int, n: int, seed: int = 0) -> np.ndarray:
    """[k, n] int64 reps from a seed, led by int64 min, max, -1 and 0."""
    rng = np.random.default_rng(seed)
    reps = rng.integers(_I64.min, _I64.max, size=(k, n), dtype=np.int64, endpoint=True)
    extremes = np.array([_I64.min, _I64.max, -1, 0], dtype=np.int64)
    for j in range(k):
        m = min(n, 4)
        reps[j, :m] = np.roll(extremes, j)[:m]
    return reps


def _port(reps: np.ndarray, nb: int, seed: int) -> np.ndarray:
    out = H.bucket_ids(torch.from_numpy(reps), nb, seed)
    assert out.dtype == torch.int32 and out.shape == (reps.shape[1],)
    return out.numpy()


@pytest.mark.parametrize("n", [0, 1, 257])
@pytest.mark.parametrize("seed", [42, 7])
@pytest.mark.parametrize("nb", [1, 8, 200, 1 << 31])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_matches_numpy_twin(k, nb, seed, n):
    reps = _reps(k, n, seed=k * 1000 + n)
    assert np.array_equal(_port(reps, nb, seed), bucket_ids_numpy(reps, nb, seed))


@pytest.mark.parametrize("nb", [1, 8, 200, 1 << 31])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_matches_xla_program(k, nb):
    reps = _reps(k, 257, seed=k)
    for seed in (42, 7):
        want = np.asarray(_bucket_ids_words(split_words_np(reps), nb, seed))
        assert np.array_equal(_port(reps, nb, seed), want)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_matches_pallas_kernel(k):
    """n = 65,536 (one Pallas grid step), interpret mode on the CPU, as the
    JAX package's own test runs it."""
    import jax.numpy as jnp

    reps = _reps(k, _PALLAS_BLOCK_N, seed=3 + k)
    want = np.asarray(bucket_ids_pallas(jnp.asarray(split_words_np(reps)), 200))
    assert np.array_equal(_port(reps, 200, 42), want)


@pytest.mark.parametrize("c", [H._C1, H._C2, 0x85EBCA6B, 0xC2B2AE35, 5, 0xFFFFFFFF])
def test_mul32_exact_at_extremes(c):
    xs = [0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF]
    got = H._mul32(torch.tensor(xs, dtype=torch.int64), c).tolist()
    assert got == [(x * c) & 0xFFFFFFFF for x in xs]


def test_plain_version_does_not_count_launches():
    before = H.launches
    H.bucket_ids(torch.from_numpy(_reps(1, 10)), 8)
    assert H.launches == before


@pytest.mark.parametrize(
    "bad, nb",
    [
        (torch.zeros(5, dtype=torch.int64), 8),  # 1-D
        (torch.zeros((1, 5), dtype=torch.int32), 8),  # wrong dtype
        (torch.zeros((0, 5), dtype=torch.int64), 8),  # no key column
        (torch.zeros((1, 5), dtype=torch.int64), 0),  # no bucket
        (torch.zeros((1, 5), dtype=torch.int64), (1 << 31) + 1),
        (np.zeros((1, 5), dtype=np.int64), 8),  # not a tensor
    ],
)
def test_wrapper_rejects_what_the_kernel_cannot_take(bad, nb):
    with pytest.raises((ValueError, TypeError)):
        H.bucket_ids(bad, nb)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        H.bucket_ids_kernel(torch.zeros((1, 4), dtype=torch.int64), 8)


def test_kernel_registry_names_wrapper_plain_version_and_source():
    import importlib
    import os

    assert set(port_ops.launch_counts()) == set(port_ops.KERNEL_TWINS)
    for mod, wrapper, plain, source in port_ops.KERNEL_TWINS.values():
        m = importlib.import_module(mod)
        assert callable(getattr(m, wrapper)) and callable(getattr(m, plain))
        assert os.path.isfile(os.path.join(os.path.dirname(kernels._PKG_DIR), source))
    port_ops.reset_launch_counts()
    assert set(port_ops.launch_counts().values()) == {0}


def test_build_dir_is_keyed_by_sources_and_ignored_by_git():
    d = kernels.build_dir()
    assert d == kernels.build_dir()
    assert "/build/hyperspace_tpu_torch/" in d
    assert any(s.endswith("murmur3_bucket.cu") for s in kernels.sources())


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "build_dir", lambda: str(tmp_path / "b"))
    with pytest.raises(kernels.KernelBuildError):
        kernels.build_all()
