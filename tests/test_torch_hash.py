"""Kernel B1 (murmur3 bucket ids) of the PyTorch port against the JAX
package: the plain PyTorch version must equal the numpy twin, the XLA
program and the Pallas kernel (interpret mode) bit for bit. The CUDA
kernel itself runs only on the card; chip_smoke.py holds it against the
plain version there."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import ctypes

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

    assert set(port_ops.launch_counts()) == set(port_ops.KERNEL_TWINS) | set(
        port_ops.ROUTE_COUNTERS)
    for mod, attr in port_ops.ROUTE_COUNTERS.values():
        assert isinstance(getattr(importlib.import_module(mod), attr), int)
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


# --- the kernel's remainder by precomputed constants -------------------------

_U32 = (1 << 32) - 1
_FIXED_DIVISORS = [1, 2, 3, 7, 200, 255, 256, (1 << 16) + 1, (1 << 31) - 1, 1 << 31]
_RANDOM_DIVISORS = [
    int(d) for d in np.random.default_rng(2019).integers(1, (1 << 31) + 1, size=64)
]


def _device_remainder(h: np.ndarray, m: int, d: int) -> np.ndarray:
    """``finish``'s remainder in csrc/murmur3_bucket.cu, step by step in
    uint64 (numpy array products wrap mod 2^64 as the device's do):
    low = m * h; t = hi32(low) * d + umulhi(lo32(low), d); r = t >> 32."""
    u64 = np.uint64
    low = u64(m) * h.astype(u64)
    umulhi = ((low & u64(_U32)) * u64(d)) >> u64(32)
    t = (low >> u64(32)) * u64(d) + umulhi
    return t >> u64(32)


def _dividends(d: int, seed: int) -> np.ndarray:
    q = _U32 // d
    edge = [0, 1, d - 1, d, d + 1, _U32, (1 << 32) - d, q * d - 1, q * d, q * d + 1]
    rand = np.random.default_rng(seed).integers(0, 1 << 32, size=4096, dtype=np.uint64)
    edge = np.array([x for x in edge if 0 <= x <= _U32], dtype=np.uint64)
    return np.concatenate([edge, rand])


@pytest.mark.parametrize("d", _FIXED_DIVISORS + _RANDOM_DIVISORS)
def test_kernel_remainder_equals_modulo(d):
    m = H.fastmod_m(d)
    assert 0 <= m < 1 << 64 and (m == 0) == (d == 1)
    h = _dividends(d, seed=d)
    assert np.array_equal(_device_remainder(h, m, d), h % np.uint64(d))


# --- the wrapper's host logic ------------------------------------------------


def _view(k: int, n: int, offset_rows: int) -> torch.Tensor:
    """A contiguous [k, n] int64 view whose plane 0 starts ``offset_rows``
    int64s into a fresh (64-byte aligned) CPU allocation."""
    buf = torch.zeros(k * n + offset_rows, dtype=torch.int64)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset_rows:].view(k, n)
    assert view.is_contiguous()
    return view


@pytest.mark.parametrize(
    "k, n, offset_rows, want",
    [
        (1, 5, 0, 0b1),
        (1, 5, 1, 0b0),  # plane 0 eight bytes off a 16-byte boundary
        (2, 6, 0, 0b11),
        (2, 6, 1, 0b00),
        (2, 5, 0, 0b01),  # odd n: plane 1 starts 40 bytes in
        (3, 5, 0, 0b101),
        (3, 5, 1, 0b010),  # odd n and an offset view
        (3, 6_001_215, 0, 0b101),
        (3, 6_001_215, 1, 0b010),
        (4, 7, 2, 0b0101),
        (40, 1, 0, 0x55555555),  # only planes 0..31 carry a bit
    ],
)
def test_aligned_planes_is_decided_per_plane(k, n, offset_rows, want):
    reps = _view(k, n, offset_rows)
    assert H.aligned_planes(reps) == want
    for j in range(min(k, 32)):
        assert bool(want >> j & 1) == (reps[j].data_ptr() % 16 == 0)


_C_ARGTYPES = [
    ctypes.c_void_p,
    ctypes.c_void_p,
    ctypes.c_int64,
    ctypes.c_int,
    ctypes.c_int64,
    ctypes.c_uint64,
    ctypes.c_int64,
    ctypes.c_uint32,
    ctypes.c_void_p,
]


@pytest.fixture
def fake_c_function(monkeypatch):
    """Stand a ctypes callback in for hs_murmur3_bucket_ids, so that every
    argument goes through the C types the wrapper declares; returns the
    list of calls it received and lets a test set the error code."""
    from hyperspace_tpu_torch import kernels as port_kernels

    state = {"calls": [], "rc": 0}

    def c_function(*args):
        state["calls"].append(args)
        return state["rc"]

    proto = ctypes.CFUNCTYPE(ctypes.c_int, *_C_ARGTYPES)
    lib = type("FakeLib", (), {"hs_murmur3_bucket_ids": proto(c_function)})()
    monkeypatch.setattr(port_kernels, "load", lambda name: lib)
    monkeypatch.setattr(H, "launches", 0)
    H._kernel_fn.cache_clear()
    yield state
    H._kernel_fn.cache_clear()


@pytest.mark.parametrize(
    "k, n, offset_rows, nb, seed",
    [
        (1, 6_001_215, 0, 200, 42),
        (2, 5, 0, 1, 7),
        (2, 6, 0, 2, 42),  # m = 2^63 needs the unsigned 64-bit argument
        (3, 5, 1, (1 << 31) - 1, -1),
        (3, 129, 1, 1 << 31, (1 << 32) + 5),
    ],
)
def test_launch_packs_arguments_for_the_c_function(fake_c_function, k, n, offset_rows, nb, seed):
    reps = _view(k, n, offset_rows)
    out = torch.empty(n, dtype=torch.int32)
    H._launch(reps, out, nb, seed, 0xABC0)
    lib_fn = H._kernel_fn()
    assert list(lib_fn.argtypes) == _C_ARGTYPES and lib_fn.restype is ctypes.c_int
    (args,) = fake_c_function["calls"]
    want = (
        reps.data_ptr(),
        out.data_ptr(),
        n,
        k,
        nb,
        ((1 << 64) - 1) // nb + 1 & ((1 << 64) - 1),
        seed & 0xFFFFFFFF,
        H.aligned_planes(reps),
        0xABC0,
    )
    assert args == want
    assert H.launches == 1


def test_launch_raises_on_a_c_error_and_counts_no_launch(fake_c_function):
    fake_c_function["rc"] = 716  # cudaErrorMisalignedAddress
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        H._launch(_view(2, 5, 0), torch.empty(5, dtype=torch.int32), 8, 42, 0)
    assert H.launches == 0


def test_launch_counts_nothing_for_no_rows(fake_c_function):
    H._launch(_view(1, 0, 0), torch.empty(0, dtype=torch.int32), 8, 42, 0)
    assert len(fake_c_function["calls"]) == 1 and H.launches == 0


def test_non_contiguous_reps_are_refused(fake_c_function):
    reps = torch.zeros((5, 2), dtype=torch.int64).t()
    assert not reps.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        H._launch(reps, torch.empty(5, dtype=torch.int32), 8, 42, 0)
    with pytest.raises(ValueError, match="CUDA"):
        H.bucket_ids_kernel(reps, 8)
    assert fake_c_function["calls"] == [] and H.launches == 0
    # the plain version takes any layout
    want = bucket_ids_numpy(reps.numpy().copy(), 8, 42)
    assert np.array_equal(H.bucket_ids(reps, 8).numpy(), want)


def test_offset_view_takes_the_plain_version_on_the_cpu():
    reps = _view(3, 5, 1)
    reps.copy_(torch.from_numpy(_reps(3, 5, seed=11)))
    want = bucket_ids_numpy(reps.numpy(), 200, 42)
    assert np.array_equal(H.bucket_ids(reps, 200).numpy(), want)
