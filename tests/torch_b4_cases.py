"""Edge cases of kernel B4's two search branches (``csrc/bucket_match.cu``),
shared by ``test_torch_join.py`` (plain version against the JAX package,
on the CPU) and ``test_torch_cuda.py`` (kernel against the plain version,
on the card). numpy only.

B4 matches a warp's left rows segment by segment: in a window of at
most ``WINDOW`` right keys copied into shared memory when one holds every
key up to the rows' greatest, and row by row in global memory otherwise.
Each case is (left keys, left offsets, right keys, right offsets), every
segment ascending."""

import torch_threads  # noqa: F401  (caps torch's CPU threads first)

import numpy as np

WINDOW = 512  # kWindow in csrc/bucket_match.cu (test_torch_join.py holds them equal)


def _segments(parts):
    keys = [np.sort(np.asarray(p, dtype=np.int64)) for p in parts]
    offs = np.concatenate([[0], np.cumsum([len(k) for k in keys])]).astype(np.int64)
    return np.concatenate(keys) if keys else np.zeros(0, np.int64), offs


def _window_case(extra):
    """One full group (left keys 0..31) whose window, [lower bound of 0,
    upper bound of 31), holds WINDOW / 32 right keys per left key plus
    ``extra`` more 31s, between right keys outside it on both sides."""
    r = np.concatenate([np.repeat(np.arange(32), WINDOW // 32), [31] * extra, [-5] * 20,
                        [100] * 50])
    return _segments([np.arange(32)]) + _segments([r])


def _random_case(seed, l_sizes, r_sizes, hi):
    rng = np.random.default_rng(seed)
    l = [rng.integers(0, hi, s, endpoint=True) for s in l_sizes]
    r = [rng.integers(0, hi, s, endpoint=True) for s in r_sizes]
    return _segments(l) + _segments(r)


def b4_edge_cases():
    """label -> (l, l_offs, r, r_offs)."""
    cases = {
        # positions 10, 11 and 12 are one-row segments inside group 0
        "group across three one-row segments": _random_case(
            1, [10, 1, 1, 1, 45], [20, 3, 1, 2, 60], 5),
        f"window of exactly {WINDOW} keys": _window_case(0),
        f"window of {WINDOW + 1} keys": _window_case(1),
        f"all-equal segment wider than {WINDOW}": _segments([[5] * 64]) + _segments(
            [[5] * (2 * WINDOW)]),
        # the window's WINDOW keys all lie below the group's greatest key
        f"all {WINDOW} window keys below a key": _segments([[0, 3, 1000]]) + _segments(
            [np.concatenate([np.arange(WINDOW) * 3, [2000]])]),
    }
    # ragged tails; the last case's groups span one to three key values,
    # so their windows fall on both sides of WINDOW
    for n, m in ((1, 400), (31, 800), (33, 800), (32 * 37 + 1, 12000)):
        cases[f"n = {n}"] = _random_case(n, [n], [m], 50)
    return cases
