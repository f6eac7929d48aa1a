"""The port's Bloom filter ops (kernel B7's plain versions) against the
JAX package on the CPU, exactly: ``optimal_params`` over a grid, the bit
indices element by element over ``tests/torch_b7_cases.py`` (the wrap
case included), the built filters' packed words and the probe masks. The
kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import bloom as JB
from hyperspace_tpu.ops.hash import hash_words, split_words_np
from hyperspace_tpu_torch import ops as port_ops
from hyperspace_tpu_torch.ops import bloom as TB
from hyperspace_tpu_torch.ops import hash as TH
from torch_b7_cases import BUILD_CASES, CASES, WRAP_M, case_id, reps_for, words_from_indices

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_indices(reps, m, k):
    return np.asarray(JB._bit_indices(jnp.asarray(split_words_np(reps[None, :])), m, k))


@pytest.mark.parametrize("fpp", [0.001, 0.01, 0.05, 0.5, 0.99])
def test_optimal_params_equal_the_reference(fpp):
    for items in (0, 1, 10, 1000, 10_000, 600_000, 10_000_000):
        assert TB.optimal_params(items, fpp) == JB.optimal_params(items, fpp), items


def test_phase_11_parameters():
    """The l_orderkey sketch of ``chip_smoke.py`` phase 11."""
    assert TB.optimal_params(600_000, 0.01) == (5_751_040, 7)


@pytest.mark.parametrize("seed", [0, 42, 0x9747B28C, 0x85EBCA6B])
def test_hash_words_equal_the_reference(seed):
    reps = reps_for((1000, 64, 1, "random")).reshape(2, 500)
    want = np.asarray(hash_words(jnp.asarray(split_words_np(reps)), seed))
    got = TH.hash_words_torch(torch.from_numpy(reps), seed).numpy()
    assert got.dtype == np.int64 and (got >= 0).all() and (got < 1 << 32).all()
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bit_indices_equal_the_reference(case):
    n, m, k, _fill = case
    reps = reps_for(case)
    got = TB.bit_indices(torch.from_numpy(reps), m, k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (k, n)
    if n == 0:
        return  # the reference's jitted program takes no empty input
    assert np.array_equal(got.numpy(), _reference_indices(reps, m, k))


def test_wrap_case_needs_the_32_bit_sum():
    """At ``WRAP_M`` the sum h1 + j·h2 passes 2^32 for many rows and 2^32
    is no multiple of m: a sum kept in int64 without the mask gives other
    indices than the reference, the plain version's gives its own."""
    reps = reps_for((65_537, WRAP_M, 16, "random"))
    want = _reference_indices(reps, WRAP_M, 16)
    t = torch.from_numpy(reps)
    h1 = TH.hash_words_torch(t[None, :], TB.SEED1)
    h2 = TH.hash_words_torch(t[None, :], TB.SEED2) | 1
    j = torch.arange(16)[:, None]
    unmasked = torch.remainder(h1[None, :] + j * h2[None, :], WRAP_M).numpy()
    assert ((h1[None, :] + j * h2[None, :]) >= 1 << 32).float().mean() > 0.4
    assert not np.array_equal(unmasked, want)
    assert np.array_equal(TB.bit_indices_torch(t, WRAP_M, 16).numpy(), want)


@pytest.mark.parametrize("case", BUILD_CASES, ids=case_id)
def test_build_bloom_equals_the_reference(case):
    n, m, k, _fill = case
    reps = reps_for(case)
    got = TB.build_bloom(torch.from_numpy(reps), m, k)
    assert got.dtype == torch.int64 and tuple(got.shape) == (m // 64,)
    words = got.numpy().view(np.uint64)
    assert np.array_equal(words, JB.build_bloom(reps, m, k))
    if n:
        assert np.array_equal(words, words_from_indices(_reference_indices(reps, m, k), m))


@pytest.mark.parametrize("m, k", [(64, 1), (95_872, 7), (5_751_040, 7), (95_872, 16)])
def test_might_contain_equals_the_reference(m, k):
    built = reps_for((1000, m, k, "random"))
    words = JB.build_bloom(built, m, k)
    probe = np.concatenate([built[::7], reps_for((1000, m, k, "strings")), reps_for(
        (33, m, k, "edges"))])
    want = JB.might_contain(words, probe, m, k)
    got = TB.might_contain(torch.from_numpy(words.view(np.int64)), torch.from_numpy(probe), m, k)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert got.numpy()[: len(built[::7])].all()  # no false negatives
    empty = TB.might_contain(torch.from_numpy(words.view(np.int64)),
                             torch.zeros(0, dtype=torch.int64), m, k)
    assert empty.shape == (0,) and JB.might_contain(words, np.zeros(0, np.int64), m, k).shape == (0,)


@pytest.mark.parametrize("m, k", [(64, 1), (95_872, 7), (5_751_040, 7), (95_872, 16)])
def test_might_contain_over_stacked_filters_equals_each_filter(m, k):
    """The probe's form: [F, m / 64] words -> [F, n], row f the reference's
    mask against filter f (an empty filter included)."""
    filters = [JB.build_bloom(reps_for((n, m, k, "random")) + i, m, k)
               for i, n in enumerate((1000, 33, 0))]
    probe = np.concatenate([reps_for((1000, m, k, "random"))[::5], reps_for((33, m, k, "edges"))])
    got = TB.might_contain(torch.from_numpy(np.stack(filters).view(np.int64)),
                           torch.from_numpy(probe), m, k)
    assert got.shape == (3, len(probe))
    for f, words in enumerate(filters):
        assert np.array_equal(got[f].numpy(), JB.might_contain(words, probe, m, k))
    empty = TB.might_contain(torch.from_numpy(np.stack(filters).view(np.int64)),
                             torch.zeros(0, dtype=torch.int64), m, k)
    assert empty.shape == (3, 0)


class _FaultedOutput:
    """A CUDA tensor whose kernel faulted while it ran: torch raises at the
    copy to the host."""

    device = torch.device("cuda")

    def cpu(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_to_host_raises_a_faulted_run_as_a_launch_error():
    from hyperspace_tpu_torch.kernels import KernelLaunchError

    with pytest.raises(KernelLaunchError, match="while it ran"):
        TB.to_host(_FaultedOutput())
    t = torch.arange(3)
    assert TB.to_host(t) is t


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    reps = torch.from_numpy(reps_for((1000, 95_872, 7, "random")))
    port_ops.reset_launch_counts()
    assert torch.equal(TB.bit_indices(reps, 95_872, 7), TB.bit_indices_torch(reps, 95_872, 7))
    assert torch.equal(TB.build_bloom(reps, 95_872, 7), TB.build_bloom_torch(reps, 95_872, 7))
    assert port_ops.launch_counts()["bloom_bits"] == 0
    assert port_ops.KERNEL_TWINS["bloom_bits"] == (
        "hyperspace_tpu_torch.ops.bloom",
        "bit_indices_kernel",
        "bit_indices_torch",
        "hyperspace_tpu_torch/csrc/bloom_bits.cu",
    )


@pytest.mark.parametrize(
    "call, args, error",
    [
        (TB.bit_indices, (torch.zeros(3, dtype=torch.int32), 64, 1), ValueError),
        (TB.bit_indices, (torch.zeros((2, 3), dtype=torch.int64), 64, 1), ValueError),
        (TB.bit_indices, (torch.zeros(3, dtype=torch.int64), 0, 1), ValueError),
        (TB.bit_indices, (torch.zeros(3, dtype=torch.int64), (1 << 31) + 1, 1), ValueError),
        (TB.bit_indices, (torch.zeros(3, dtype=torch.int64), 64, 0), ValueError),
        (TB.build_bloom, (torch.zeros(3, dtype=torch.int64), 96, 1), ValueError),
        (TB.bit_indices, (np.zeros(3, dtype=np.int64), 64, 1), TypeError),
        (TB.bit_indices, (torch.zeros(3, dtype=torch.int64, device="meta"), 64, 1), ValueError),
    ],
)
def test_wrappers_refuse_what_the_kernel_cannot_take(call, args, error):
    with pytest.raises(error):
        call(*args)


def test_kernel_without_a_card_raises():
    """A kernel wrapper never takes the plain version: on a CPU tensor it
    refuses instead of computing."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        TB.bit_indices_kernel(torch.zeros(3, dtype=torch.int64), 64, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TB.build_bloom_kernel(torch.zeros(3, dtype=torch.int64), 64, 1)


def test_kernel_source_uses_the_plain_versions_constants():
    with open(os.path.join(ROOT, "hyperspace_tpu_torch", "csrc", "bloom_bits.cu")) as fh:
        src = fh.read()
    seeds = dict(re.findall(r"constexpr uint32_t (kSeed[12]) = (0x[0-9A-F]+)u;", src))
    assert int(seeds["kSeed1"], 16) == TB.SEED1 == 0x9747B28C
    assert int(seeds["kSeed2"], 16) == TB.SEED2 == 0x85EBCA6B
    assert "m <= (int64_t(1) << 31)" in src and TB.MAX_BITS == 1 << 31
