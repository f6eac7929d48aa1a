"""Kernel B7's build by route, on the CPU: the route plan
(``ops/bloom.build_plan``) against the constants of
``csrc/bloom_bits.cu``, and the plain model of the two shared-memory
routes (``build_bloom_routes_torch``: the block route's one partial
filter a block, the binned route's slices, each the OR of its copies)
held exactly against the plain build
(``build_bloom_torch``) and the JAX package's ``build_bloom`` over
``tests/torch_b7_cases.py``'s build cases and route boundaries. The
kernel itself is held against the plain version on the card
(``test_torch_cuda.py``, ``chip_smoke.py`` phase 3)."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import os
import re

import numpy as np
import pytest
import torch

from hyperspace_tpu.ops import bloom as JB
from hyperspace_tpu_torch.ops import bloom as TB
from torch_b7_cases import (BINNED_BITS, BLOCK_BITS, BOUNDARY_CASES, BUILD_CASES, PHASE_M,
                            WRAP_M, case_id, reps_for)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the route's blocks a card holds at once, as the model is given them:
#: one, a few, and more than any case asks for
RESIDENT = (1, 3, 64, 264)


def _source_constants() -> dict:
    with open(os.path.join(ROOT, "hyperspace_tpu_torch", "csrc", "bloom_bits.cu")) as fh:
        src = fh.read()
    found = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    found.update({k: 1 << int(v) for k, v in re.findall(
        r"constexpr int64_t (k\w+) = int64_t\(1\) << (\d+);", src)})
    return found


def test_kernel_source_shares_the_route_constants():
    """The route boundaries and the launch shapes are one constant each
    in the C source and in ``ops/bloom.py``."""
    c = _source_constants()
    assert c["kBlockMaxBits"] == TB.BLOCK_MAX_BITS == BLOCK_BITS
    assert c["kBinnedMaxBits"] == TB.BINNED_MAX_BITS == BINNED_BITS
    assert c["kBlockThreads"] == TB.BLOCK_THREADS
    assert c["kRowsPerBlock"] == TB.ROWS_PER_BLOCK
    assert c["kSliceShift"] == TB.SLICE_SHIFT
    assert c["kBinThreads"] == TB.BIN_THREADS and TB.TILE_ROWS == 2 * TB.BIN_THREADS
    assert c["kChunk"] == TB.CHUNK and TB.TILE_ENTRIES == TB.TILE_ROWS * TB.CHUNK
    assert c["kMaxSlices"] << TB.SLICE_SHIFT == TB.BINNED_MAX_BITS


@pytest.mark.parametrize(
    "m, route, block_bits",
    [
        (64, "block", 64),
        (95_872, "block", 95_872),
        (PHASE_M, "binned", 1 << 16),  # 88 slices
        (BLOCK_BITS, "block", BLOCK_BITS),
        (BLOCK_BITS + 64, "binned", 1 << 16),  # 17 slices, the last of 64 bits
        (BINNED_BITS, "binned", 1 << 16),  # 256 slices
        (BINNED_BITS + 64, "global", 0),
        (WRAP_M, "global", 0),
        (TB.MAX_BITS, "global", 0),
    ],
)
def test_build_plan_takes_its_route_from_m_alone(m, route, block_bits):
    assert TB.build_route(m) == route
    for n in (1, 65_537, 6_001_215):
        for k in (1, 7, 16):
            for resident in RESIDENT:
                plan = TB.build_plan(m, n, k, resident)
                assert (plan.route, plan.block_bits) == (route, block_bits)
                if route == "binned":
                    slices = -(-m // (1 << 16))
                    assert (slices - 1) << 16 < m <= slices << 16
                    assert plan.partials == max(resident // slices, 1)
                else:
                    assert plan.scratch_bytes == 0


@pytest.mark.parametrize("m", [64, 95_872, BLOCK_BITS])
def test_block_route_partials(m):
    """One block for each ROWS_PER_BLOCK rows, at most what the card holds
    at once, none for no rows."""
    assert TB.build_plan(m, 0, 7, 64).partials == 0
    for n in (1, 4096, 4097, 750_152, 6_001_215):
        for resident in RESIDENT:
            assert TB.build_plan(m, n, 7, resident).partials == min(-(-n // 4096), resident)


@pytest.mark.parametrize("k", [1, 7, 8, 9, 16])
def test_binned_route_scratch(k):
    """The scratch holds TILE_ENTRIES 16-bit entries for each tile (a tile
    is TILE_ROWS rows and at most CHUNK indices of each), then each tile's
    slices + 1 16-bit offsets, rounded up to 16 bytes."""
    for n in (0, 1, 1024, 1025, 750_152):
        tiles = -(-n // 1024) * -(-k // 8)
        offsets = tiles * 89 * 2
        want = tiles * 8192 * 2 + -(-offsets // 16) * 16
        assert TB.build_plan(PHASE_M, n, k, 1).scratch_bytes == want


def test_phase_11_filter_takes_the_binned_route():
    """phase 11's sketch (750,152 rows a file, k = 7) is built on the
    binned route: 88 slices of 8 KiB, 733 tiles of scratch, 3 copies a
    slice on a card that holds 264 blocks (an H100's 132 SMs, two each)."""
    plan = TB.build_plan(PHASE_M, 750_152, 7, 264)
    assert plan == TB.BuildPlan("binned", 1 << 16, 3,
                                733 * 8192 * 2 + -(-733 * 89 * 2 // 16) * 16)


@pytest.mark.parametrize("case", BUILD_CASES + BOUNDARY_CASES, ids=case_id)
def test_route_model_equals_the_plain_build_and_the_reference(case):
    n, m, k, _fill = case
    reps = reps_for(case)
    t = torch.from_numpy(reps)
    want = JB.build_bloom(reps, m, k)
    plain = TB.build_bloom_torch(t, m, k)
    assert np.array_equal(plain.numpy().view(np.uint64), want)
    if TB.build_route(m) == "global":  # its plain version is the plain build
        with pytest.raises(ValueError, match="global route"):
            TB.build_bloom_routes_torch(t, m, k, 1)
        return
    for resident in RESIDENT:
        got = TB.build_bloom_routes_torch(t, m, k, resident)
        assert got.dtype == torch.int64 and tuple(got.shape) == (m // 64,)
        assert torch.equal(got, plain)


def test_route_model_partials_hold_only_their_rows():
    """Each copy holds the bits of the rows the kernels give it: on the
    block route row r goes to block (r // BLOCK_THREADS) mod partials; on
    the binned route a slice's copy p takes the tiles t = p mod partials
    (k <= CHUNK: tile t is rows [1024 t, + 1024)). The model is the OR of
    those filters, and no copy alone holds it."""
    k = 7
    for m, n, unit, resident in ((95_872, 4 * 4096, TB.BLOCK_THREADS, 3),
                                 (PHASE_M, 4 * 1024 + 1, TB.TILE_ROWS, 264)):
        reps = torch.from_numpy(reps_for((n, m, k, "random")))
        plan = TB.build_plan(m, n, k, resident)
        assert plan.partials == 3
        owner = (torch.arange(n) // unit) % 3
        filters = [TB.build_bloom_torch(reps[owner == b], m, k) for b in range(3)]
        merged = TB.build_bloom_routes_torch(reps, m, k, resident)
        assert torch.equal(merged, filters[0] | filters[1] | filters[2])
        assert not any(torch.equal(merged, f) for f in filters)
