"""The port's hand-written kernels on the card, against their plain
PyTorch versions. Every test here is marked ``cuda`` and skips without a
CUDA device; the CPU tests hold the plain versions against the JAX
package. This file imports neither JAX nor the JAX package, so on a
machine with the card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from hyperspace_tpu_torch.ops import hash as H
from hyperspace_tpu_torch.ops import join as J

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ragged(rng, sizes, lo, hi):
    sizes = np.asarray(sizes, dtype=np.int64)
    keys = rng.integers(lo, hi, int(sizes.sum()), dtype=np.int64, endpoint=True)
    return keys, np.concatenate([[0], np.cumsum(sizes)])


@pytest.mark.parametrize(
    "l_sizes, r_sizes, lo, hi",
    [
        ([50, 0, 300, 7], [40, 60, 0, 9], 0, 60),
        ([33, 2000, 31], [100, 2000, 1], 0, 2),
        ([1000, 1000], [1000, 1000], -(1 << 63), (1 << 63) - 1),
    ],
)
def test_b4_equals_its_plain_version(cuda_device, l_sizes, r_sizes, lo, hi):
    rng = np.random.default_rng(len(l_sizes) + hi % 97)
    l, l_offs = _ragged(rng, l_sizes, lo, hi)
    r, r_offs = _ragged(rng, r_sizes, lo, hi)
    l[::7], r[::5] = hi, hi  # the range's ends as real keys on both sides
    l[1::11], r[1::4] = lo, lo
    lk, l_row = J.segment_sort(torch.from_numpy(l).to(cuda_device), l_offs)
    rk, r_row = J.segment_sort(torch.from_numpy(r).to(cuda_device), r_offs)
    before = J.launches
    got = J.match_pairs_kernel(lk, l_offs, rk, r_offs, l_row, r_row)
    torch.cuda.synchronize()
    assert J.launches == before + 2
    want = J.match_pairs_torch(lk, l_offs, rk, r_offs, l_row, r_row)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0].numel() > 0


def test_b4_launches_nothing_for_an_empty_side(cuda_device):
    k = torch.arange(9, device=cuda_device)
    z = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    before = J.launches
    for args in ((z, [0, 0], k, [0, 9]), (k, [0, 9], z, [0, 0])):
        li, ri = J.match_pairs_kernel(*args)
        assert li.shape == ri.shape == (0,) and li.device.type == "cuda"
    assert J.launches == before


def test_b1_equals_its_plain_version(cuda_device):
    rng = np.random.default_rng(3)
    reps = torch.from_numpy(
        rng.integers(-(1 << 63), (1 << 63) - 1, size=(2, 1001), dtype=np.int64)
    ).to(cuda_device)
    got = H.bucket_ids_kernel(reps, 200)
    assert torch.equal(got, H.bucket_ids_torch(reps, 200))
