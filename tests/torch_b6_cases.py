"""Cases of kernel B6, the z-order interleave (``ops/zorder.interleave``):
shared by the CPU test against the JAX package (``test_torch_zorder.py``,
the small ones), the CUDA test against the plain version
(``test_torch_cuda.py``) and ``chip_smoke.py``'s phase 3 (all of them).

A case is ``(n, k, bits, fill, offset)``: ``n`` rows of ``k`` words below
2^bits, filled with 0 (``"zero"``), with 2^bits - 1 (``"top"``) or with
seeded random words (``"random"``); ``offset`` 1 hands the kernel a view
whose words start 4 bytes past a 16-byte boundary. The sizes straddle a
warp (31, 33) and a block (4097) and reach TPC-H SF1 lineitem's
6,001,215 rows; k and bits cover the kernel's specialised paths (k = 1
with any bits, k = 2-4 with bits <= 16) and its generic one, with
k * bits = 32, 33, 48 and 128 among them.
"""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import itertools

import numpy as np

N_FULL = 6_001_215
SIZES = (0, 1, 31, 33, 4097, N_FULL)
KS = (1, 2, 3, 4)
BITS = (1, 8, 11, 16, 31, 32)
FILLS = ("zero", "top", "random")


def _cases():
    out = []
    for n, k, bits in itertools.product(SIZES, KS, BITS):
        fills = FILLS if n <= 4097 else ("random",)
        for fill in fills:
            out.append((n, k, bits, fill, 0))
    for k, bits in ((1, 16), (2, 16), (3, 11), (4, 32)):
        out.append((4097, k, bits, "random", 1))
        out.append((N_FULL, k, bits, "random", 1))
    return out


CASES = _cases()
#: the cases small enough for the CPU tests against the JAX package
SMALL_CASES = [c for c in CASES if c[0] <= 4097]


def case_id(case) -> str:
    n, k, bits, fill, offset = case
    return f"n{n}-k{k}-b{bits}-{fill}" + ("-off4" if offset else "")


def words_for(case, seed: int = 11) -> np.ndarray:
    """[k, n + offset] uint32 words of ``case`` (the first ``offset``
    column is padding: the case's words are ``[:, offset:]``)."""
    n, k, bits, fill, offset = case
    m = n + offset
    top = (1 << bits) - 1
    if fill == "zero":
        return np.zeros((k, m), dtype=np.uint32)
    if fill == "top":
        return np.full((k, m), top, dtype=np.uint32)
    rng = np.random.default_rng(seed + 7 * n + 3 * k + bits)
    return rng.integers(0, top, size=(k, m), dtype=np.uint64, endpoint=True).astype(np.uint32)


def words_tensor(case, device):
    """``case``'s words as the [k, n] int32 tensor B6 takes, on ``device``:
    with offset 1, a view of a flat buffer whose words start 4 bytes past
    a 16-byte boundary (rows contiguous, so the view is contiguous)."""
    import torch

    n, k, _bits, _fill, offset = case
    w = words_for(case)
    if not offset:
        return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(device)
    flat = torch.from_numpy(
        np.concatenate([[0], w[:, offset:].reshape(-1)]).astype(np.uint32).view(np.int32)
    ).to(device)
    return flat[1:].view(k, n)


def case_words(case) -> np.ndarray:
    """``case``'s [k, n] uint32 words, without the padding column."""
    return np.ascontiguousarray(words_for(case)[:, case[4]:])
