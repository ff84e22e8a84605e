"""Triton walk kernel (search/triton_walk.py) vs the host oracle, run in
the Pallas interpreter."""

import numpy as np
import pytest

from needle_tpu.search import triton_walk as W
from needle_tpu.search.geometry import (
    D_TILE,
    GROUP_DIAGS,
    full_block_mask,
    n_groups_for,
)
from needle_tpu.search.jax_impl import _diag_candidates
from needle_tpu.search.oracle import compute_run_table, find_run_ends


def _oracle_ends(src, dst, nv, mv, thr):
    """(i, j, run) of every maximal run, from the reference DP table."""
    return find_run_ends(compute_run_table(src[:nv], dst[:mv], thr))


def _oracle_counts(ends, lm, n_pad, width):
    out = np.zeros(width, np.int64)
    for i, j, L in ends:
        if L >= lm:
            out[j - i + n_pad - 1] += 1
    return out


def _required_mask(ends, lm, n_pad):
    """Per-group bits of every row block holding a row of a qualifying
    run: the least band mask under which the masked walk stays exact."""
    bm = np.zeros(n_groups_for(n_pad), np.int64)
    for i, j, L in ends:
        if L >= lm:
            g = (j - i + n_pad - 1) // GROUP_DIAGS
            for b in range((i - L + 2) // D_TILE, (i + 1) // D_TILE + 1):
                bm[g] |= 1 << b
    return bm


def _counts(nv, mv, lm, thr, src, dst, n_pad, bm=None):
    return np.asarray(
        W.batch_counts(nv, mv, lm, thr, src, dst, n_pad, bm=bm,
                       interpret=True)
    )


def _planted(rng, chunk, n_pad, at_src, at_dst, run_len):
    shared = rng.integers(0, 2**32, size=run_len, dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    for r in range(chunk):
        src[r, at_src : at_src + run_len] = shared
        dst[r, at_dst : at_dst + run_len] = shared
    return src, dst


def test_pallas_counts_match_oracle(rng):
    n_pad, chunk = 512, 4
    src, dst = _planted(rng, chunk, n_pad, 30, 50, 40)
    nv = np.array([200, 512, 150, 90], np.int32)
    mv = np.array([220, 512, 100, 250], np.int32)
    lm = np.array([10, 40, 41, 5], np.int32)
    thr = np.array([10, 10, 10, 0], np.int32)
    out = _counts(nv, mv, lm, thr, src, dst, n_pad)
    for r in range(chunk):
        for d in range(out.shape[1]):
            o = d - (n_pad - 1)
            cands = _diag_candidates(
                src[r][: nv[r]], dst[r][: mv[r]], o, int(thr[r])
            )
            expect = sum(1 for (_, _, L) in cands if L >= lm[r])
            assert expect == out[r, d], (r, o, expect, out[r, d])


@pytest.mark.parametrize("threshold", [8, 16])
def test_pallas_wide_groups_2560_match_oracle(rng, threshold):
    """n_pad=2560 spans several row blocks and diagonal blocks with
    runs far off the main diagonal; nv/mv < n_pad trims the walk."""
    n_pad, chunk = 2560, 2
    shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
    src = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=(chunk, n_pad), dtype=np.uint32)
    nv = np.array([2400, 2560], np.int32)
    mv = np.array([2300, 2560], np.int32)
    for r in range(chunk):
        src[r, 100:160] = shared
        dst[r, 2000:2060] = shared
        src[r, 2200:2260] = shared
        dst[r, 30:90] = shared
    lm = np.array([5, 3], np.int32)
    thr = np.array([threshold, threshold], np.int32)
    out = _counts(nv, mv, lm, thr, src, dst, n_pad)
    assert out.shape == (chunk, W.n_diag_blocks(n_pad) * W.BLOCK_DIAGS)
    for r in range(chunk):
        ends = _oracle_ends(src[r], dst[r], nv[r], mv[r], threshold)
        want = _oracle_counts(ends, lm[r], n_pad, out.shape[1])
        np.testing.assert_array_equal(out[r], want)
        assert want.sum() >= 2  # both planted runs found


@pytest.mark.parametrize("mask", ["ones", "random", "zero"])
@pytest.mark.parametrize("n_pad", [512, 1024, 2560])
def test_walk_matches_oracle_under_band_masks(rng, n_pad, mask):
    """Per-pair thresholds include 0 and 15, episodes shorter than the
    bucket, runs off the main diagonal. All-ones masks walk everything;
    random masks keep every row block of a qualifying run plus random
    others (the only masks the prefilter can emit), so counts stay
    oracle-exact; all-zero masks walk nothing."""
    chunk = 3
    run_len = min(90, n_pad // 4)
    src, dst = _planted(rng, chunk, n_pad, n_pad // 8, n_pad // 2, run_len)
    src[1] = dst[1]  # identical episodes: the main diagonal is one run
    nv = np.array([n_pad, n_pad - 37, n_pad // 2 + 5], np.int32)
    mv = np.array([n_pad - 100, n_pad, n_pad], np.int32)
    lm = np.array([20, 4, 30], np.int32)
    thr = np.array([0, 15, 10], np.int32)
    width = W.n_diag_blocks(n_pad) * W.BLOCK_DIAGS
    ends = [
        _oracle_ends(src[r], dst[r], nv[r], mv[r], int(thr[r]))
        for r in range(chunk)
    ]
    want = np.stack(
        [_oracle_counts(ends[r], lm[r], n_pad, width) for r in range(chunk)]
    )
    assert (want.sum(axis=1) > 0).all()
    n_groups = n_groups_for(n_pad)
    if mask == "ones":
        bm = np.full((chunk, n_groups), full_block_mask(n_pad), np.int32)
    elif mask == "random":
        extra = rng.integers(0, 2**31, size=(chunk, n_groups))
        bm = np.stack(
            [_required_mask(ends[r], lm[r], n_pad) for r in range(chunk)]
        ) | (extra & int(full_block_mask(n_pad)))
        bm = bm.astype(np.int32)
    else:
        bm = np.zeros((chunk, n_groups), np.int32)
        want = np.zeros_like(want)
    got = _counts(nv, mv, lm, thr, src, dst, n_pad, bm=bm)
    np.testing.assert_array_equal(got, want)


def test_walk_output_geometry():
    """Diagonal blocks cover all 2*n_pad - 1 diagonals for buckets that
    are not multiples of the block width; band-mask groups split evenly
    into diagonal blocks."""
    assert GROUP_DIAGS % W.BLOCK_DIAGS == 0
    for n_pad in (256, 320, 640, 2560, 5120):
        nb = W.n_diag_blocks(n_pad)
        assert (nb - 1) * W.BLOCK_DIAGS < 2 * n_pad - 1 <= nb * W.BLOCK_DIAGS
        # the last block's band-mask group exists
        assert ((nb - 1) * W.BLOCK_DIAGS) // GROUP_DIAGS < n_groups_for(n_pad)


def test_engine_with_pallas_kernel_matches_numpy(rng, monkeypatch):
    """Full search engine with the Triton walk forced (interpreted on
    CPU) must match the reference-exact numpy engine."""
    from needle_tpu import Comparator
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration
    from needle_tpu.search import jax_impl as S

    monkeypatch.setattr(S, "_KERNEL", "triton")
    monkeypatch.setattr(W, "INTERPRET", True)

    shared = rng.integers(0, 2**32, size=70, dtype=np.uint32)
    fhs = []
    for e in range(4):
        h = rng.integers(0, 2**32, size=300 + 40 * e, dtype=np.uint32)
        h[15 + 11 * e : 15 + 11 * e + 70] = shared
        ts = (2600090703 + np.arange(len(h)) * 247619033).astype(np.int64)
        fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64),
                               Duration.from_millis(300), "b" * 32))

    def run(engine):
        cmp = Comparator.from_files(
            [f"p{k}.mkv" for k in range(4)], engine=engine
        ).with_min_opening_duration(Duration.from_secs(12))
        res = cmp.run_with_frame_hashes(
            fhs, display=False, use_skip_files=False, write_skip_files=False
        )
        return [None if r.opening is None else
                (r.opening[0].total_nanos(), r.opening[1].total_nanos())
                for r in res]

    got = run("jax")
    expect = run("numpy")
    assert got == expect
    assert any(g is not None for g in got)


def test_device_extraction_overflow_falls_back(rng):
    """A diagonal with more run-ends than K_CANDS (periodic corruption)
    overflows the device extraction and must fall back to the exact host
    rescan — results identical to the NumPy oracle engine."""
    from needle_tpu import Comparator
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration

    n = 600
    step = 247619033
    base = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    fhs = []
    for e in range(3):
        h = base.copy()
        # corrupt a different sparse set per episode -> many short shared
        # runs on the main diagonal of every pair
        h[e + 3 :: 37] ^= np.uint32(0xFFFFFFFF)
        ts = (2600090703 + np.arange(n) * step).astype(np.int64)
        fhs.append(
            FrameHashes(h, ts, np.zeros(0, np.uint32),
                        np.zeros(0, np.int64),
                        Duration.from_millis(300), f"{e:032x}")
        )
    results = {}
    for engine in ("numpy", "jax"):
        cmp = Comparator.from_files(
            [f"x{k}.mkv" for k in range(3)], engine=engine
        ).with_min_opening_duration(Duration.from_secs(2))
        res = cmp.run_with_frame_hashes(
            fhs, display=False, use_skip_files=False, write_skip_files=False
        )
        results[engine] = [
            None if r.opening is None
            else (str(r.opening[0]), str(r.opening[1]))
            for r in res
        ]
    assert results["jax"] == results["numpy"]
    assert any(r is not None for r in results["jax"])
