"""Card-only checks of the Triton walk: the kernel as compiled for the GPU
(no interpreter) against the host oracle at the season's widths. They skip
on the CPU; on a GPU host run them with

    NEEDLE_TPU_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

from needle_tpu.search import triton_walk as W
from needle_tpu.search.oracle import compute_run_table, find_run_ends

pytestmark = pytest.mark.gpu


def _planted(rng, n_pad):
    shared = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    src[:, 40:160] = shared
    dst[:, n_pad // 2 : n_pad // 2 + 120] = shared
    return src, dst


@pytest.mark.parametrize("n_pad", [1280, 2560])
def test_compiled_walk_matches_oracle(gpu, rng, n_pad):
    src, dst = _planted(rng, n_pad)
    nv = np.array([n_pad, n_pad - 50], np.int32)
    mv = np.array([n_pad - 20, n_pad], np.int32)
    lm = np.array([81, 40], np.int32)
    thr = np.array([10, 0], np.int32)
    got = np.asarray(W.batch_counts(nv, mv, lm, thr, src, dst, n_pad))
    for r in range(2):
        ends = find_run_ends(
            compute_run_table(src[r][: nv[r]], dst[r][: mv[r]], int(thr[r]))
        )
        want = np.zeros(got.shape[1], np.int64)
        for i, j, L in ends:
            if L >= lm[r]:
                want[j - i + n_pad - 1] += 1
        np.testing.assert_array_equal(got[r], want)
        assert want.sum() >= 1


def test_compiled_walk_matches_interpreter(gpu, rng):
    n_pad = 2560
    src, dst = _planted(rng, n_pad)
    args = (
        np.full(2, n_pad, np.int32), np.full(2, n_pad, np.int32),
        np.array([81, 20], np.int32), np.array([10, 15], np.int32),
        src, dst, n_pad,
    )
    np.testing.assert_array_equal(
        np.asarray(W.batch_counts(*args)),
        np.asarray(W.batch_counts(*args, interpret=True)),
    )
