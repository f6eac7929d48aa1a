"""The port's build sort against the JAX package's: the permutation must
be identical (the same stable order), not just another valid one."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops.sort import partitioned_sort_permutation as jax_partitioned
from hyperspace_tpu.ops.sort import sort_permutation as jax_sort
from hyperspace_tpu_torch.ops import sort as S

_I64 = np.iinfo(np.int64)


def _case(name: str):
    """(key_reps [k, n] int64, bucket ids [n] int32, num_buckets)."""
    rng = np.random.default_rng(CASES.index(name))
    n = 3000
    if name == "duplicates":
        reps = rng.integers(0, 20, (1, n)).astype(np.int64)
        return reps, rng.integers(0, 8, n).astype(np.int32), 8
    if name == "negative":
        reps = rng.integers(-(2**40), 2**40, (1, n)).astype(np.int64)
        reps[0, :4] = [_I64.min, _I64.max, -1, 0]
        return reps, rng.integers(0, 16, n).astype(np.int32), 16
    if name == "multi_key":
        reps = np.stack(
            [
                rng.integers(-3, 3, n),
                rng.integers(_I64.min, _I64.max, n, endpoint=True),
                rng.integers(0, 4, n),
            ]
        ).astype(np.int64)
        return reps, rng.integers(0, 8, n).astype(np.int32), 8
    if name == "two_keys_ties":
        reps = rng.integers(-2, 2, (2, n)).astype(np.int64)
        return reps, rng.integers(0, 4, n).astype(np.int32), 4
    if name == "empty_buckets":
        reps = rng.integers(-100, 100, (1, n)).astype(np.int64)
        return reps, rng.choice([1, 5, 29], n).astype(np.int32), 32
    if name == "one_bucket":
        reps = rng.integers(-(2**62), 2**62, (1, n)).astype(np.int64)
        return reps, np.full(n, 3, dtype=np.int32), 200
    if name == "single_row":
        return np.array([[_I64.min]], dtype=np.int64), np.array([0], np.int32), 1
    if name == "empty":
        return np.zeros((1, 0), dtype=np.int64), np.zeros(0, np.int32), 8
    raise KeyError(name)


CASES = [
    "duplicates",
    "negative",
    "multi_key",
    "two_keys_ties",
    "empty_buckets",
    "one_bucket",
    "single_row",
    "empty",
]


@pytest.mark.parametrize("name", CASES)
def test_partitioned_sort_permutation_matches_reference(name):
    reps, bucket, nb = _case(name)
    got = S.partitioned_sort_permutation(
        torch.from_numpy(reps), torch.from_numpy(bucket), nb
    ).numpy()
    want = jax_partitioned(reps, bucket, nb)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", CASES)
def test_sort_permutation_matches_reference(name):
    reps, bucket, _nb = _case(name)
    got = S.sort_permutation(torch.from_numpy(reps), torch.from_numpy(bucket))
    assert np.array_equal(got.numpy(), jax_sort(reps, bucket))
    no_bucket = S.sort_permutation(torch.from_numpy(reps))
    assert np.array_equal(no_bucket.numpy(), jax_sort(reps))


def test_bucket_ids_outside_range_raise():
    reps = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        S.partitioned_sort_permutation(reps, torch.tensor([0, 1, 8]), 8)
    with pytest.raises(ValueError):
        S.sort_permutation(torch.zeros(3, dtype=torch.int64))
