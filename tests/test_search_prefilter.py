"""The matmul pair prefilter must NEVER change results — only skip pairs
that provably contain no qualifying run (see search/prefilter.py for the
bound) — and must actually skip unrelated pairs in mixed libraries."""

import numpy as np
import pytest

from needle_tpu.search import prefilter as pf


def test_plan_gating(monkeypatch):
    monkeypatch.delenv("NEEDLE_TPU_SEARCH_PREFILTER", raising=False)
    # auto: small work lists never prefilter
    assert pf.prefilter_plan(100, 200, 10, 2560) is None
    # auto: large work lists do, with W = biggest pow2 <= (lm+1)//2 (<=64)
    assert pf.prefilter_plan(5000, 81, 10, 2560) == 32
    assert pf.prefilter_plan(5000, 200, 10, 2560) == 64
    assert pf.prefilter_plan(5000, 2000, 10, 2560) == 64  # capped
    # W must divide n_pad
    assert pf.prefilter_plan(5000, 200, 10, 2560 + 4) is None
    # lm too small for the weakest width
    assert pf.prefilter_plan(5000, 9, 10, 2560) is None
    # bound non-positive: can never skip
    assert pf.prefilter_plan(5000, 200, 16, 2560) is None
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "off")
    assert pf.prefilter_plan(5000, 200, 10, 2560) is None
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    assert pf.prefilter_plan(4, 81, 10, 2560) == 32


def _max_blocked_corr_np(src, dst, nv, mv, w):
    """O(n^2) oracle for max_{b,t} C[b,t] on +/-1 expansions."""
    n = len(src)

    def pm(h, k):
        bits = (h[:, None] >> np.arange(32)) & 1
        out = (bits * 2 - 1).astype(np.int64)
        out[0] = 0
        out[k:] = 0
        return out

    S, T = pm(src, nv), pm(dst, mv)
    best = -(10**9)
    for b in range(n // w):
        blk = S[b * w : (b + 1) * w]
        for t in range(n):
            win = T[t : t + w]
            if len(win) < w:
                win = np.pad(win, ((0, w - len(win)), (0, 0)))
            best = max(best, int((blk * win).sum()))
    return best


def test_chunk_max_corr_exact(rng):
    n_pad, w = 128, 8
    e = 4
    table = rng.integers(0, 2**32, size=(e, n_pad), dtype=np.uint32)
    nv = [100, 128, 37, 9]
    vtab = np.zeros((e, n_pad), bool)
    for k in range(e):
        vtab[k, 1 : nv[k]] = True
    exp = pf.expand_pm1(table, vtab, n_pad)
    ia = np.array([0, 1, 2, 3], np.int32)
    ib = np.array([1, 0, 3, 2], np.int32)
    got = np.asarray(pf._chunk_max_corr(exp, ia, ib, w, 10, n_pad))
    for r in range(4):
        want = _max_blocked_corr_np(
            table[ia[r]], table[ib[r]], nv[ia[r]], nv[ib[r]], w
        )
        assert got[r] == want, (r, got[r], want)


def _fh(h, hash_ms=300):
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration

    h = np.asarray(h, dtype=np.uint32)
    step = 247619033
    ts = (2600090703 + np.arange(len(h)) * step).astype(np.int64)
    return FrameHashes(
        h, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64),
        Duration.from_millis(hash_ms), "f" * 32,
    )


def _run(fhs, threshold, min_open_s, engine):
    from needle_tpu import Comparator
    from needle_tpu.duration import Duration

    cmp = (
        Comparator.from_files(
            [f"v{k}.mkv" for k in range(len(fhs))], engine=engine
        )
        .with_hash_match_threshold(threshold)
        .with_min_opening_duration(Duration.from_secs(min_open_s))
    )
    res = cmp.run_with_frame_hashes(
        fhs, display=False, use_skip_files=False, write_skip_files=False
    )
    return [
        None
        if r.opening is None
        else (r.opening[0].total_nanos(), r.opening[1].total_nanos())
        for r in res
    ]


def test_mixed_library_results_identical_and_pairs_skipped(
    rng, monkeypatch
):
    """2 'shows' of 3 episodes: within-show pairs share a run (with bit
    flips and borderline cells), cross-show pairs share nothing. Forced-on
    prefilter must skip cross-show pairs and change NOTHING."""
    from needle_tpu.tracing import metrics

    shared_a = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    shared_b = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for show, shared in ((0, shared_a), (1, shared_b)):
        for e in range(3):
            h = rng.integers(0, 2**32, size=400, dtype=np.uint32)
            at = 30 + 40 * e
            h[at : at + 120] = shared
            flips = rng.integers(0, 120, size=5)
            h[at + flips] ^= np.uint32(1) << rng.integers(
                0, 32, size=5
            ).astype(np.uint32)
            fhs.append(_fh(h))

    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "off")
    base = _run(fhs, 10, 20, "jax")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    before = metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
    on = _run(fhs, 10, 20, "jax")
    skipped = (
        metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
        - before
    )
    assert on == base == _run(fhs, 10, 20, "numpy")
    # all 9 cross-show pairs are skippable; at least most must be
    assert skipped >= 5, f"prefilter skipped only {skipped} pairs"
    for r in base[:3]:
        assert r is not None  # the related runs were actually found


def test_adversarial_exact_threshold_run_kept(monkeypatch):
    """A run at EXACTLY l_min cells, each cell at EXACTLY the hamming
    threshold: the weakest qualifying pair must survive the prefilter."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    rng = np.random.default_rng(7)
    n = 400
    thr, min_open_s = 10, 20
    # hash step 247619033 ns -> l_min = ceil(20e9 / step) = 81 cells
    run = rng.integers(0, 2**32, size=81, dtype=np.uint32)
    h1 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    h1[37 : 37 + 81] = run
    noisy = run.copy()
    for k in range(81):  # flip exactly thr bits of every cell
        bits = rng.choice(32, size=thr, replace=False)
        for b in bits:
            noisy[k] ^= np.uint32(1) << np.uint32(b)
    h2[160 : 160 + 81] = noisy
    fhs = [_fh(h1), _fh(h2)]
    got = _run(fhs, thr, min_open_s, "jax")
    assert got == _run(fhs, thr, min_open_s, "numpy")
    assert got[0] is not None


def test_randomized_prefilter_never_changes_results(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    for trial in range(4):
        n_eps = int(rng.integers(3, 6))
        lens = rng.integers(120, 400, size=n_eps)
        shared_len = int(rng.integers(85, 140))
        shared = rng.integers(0, 2**32, size=shared_len, dtype=np.uint32)
        fhs = []
        for e in range(n_eps):
            h = rng.integers(0, 2**32, size=int(lens[e]), dtype=np.uint32)
            if e % 2 == 0 and lens[e] > shared_len + 2:
                at = int(rng.integers(1, lens[e] - shared_len))
                h[at : at + shared_len] = shared
                flips = rng.integers(0, shared_len, size=4)
                h[at + flips] ^= np.uint32(1) << rng.integers(
                    0, 32, size=4
                ).astype(np.uint32)
            fhs.append(_fh(h))
        threshold = int(rng.integers(0, 14))
        jax_res = _run(fhs, threshold, 20, "jax")
        monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "off")
        off_res = _run(fhs, threshold, 20, "jax")
        monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
        assert jax_res == off_res == _run(fhs, threshold, 20, "numpy"), (
            f"trial {trial} diverged"
        )


def test_adaptive_probe_passes_dense_library_through(rng, monkeypatch):
    """auto mode with >2048 pairs: a dense library (nothing skippable in
    the probe) must pass the tail through unfiltered; a sparse one must
    keep filtering. Soundness holds either way."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "auto")
    n_pad, n_eps = 128, 70
    ts_lm = 15  # -> w = 8

    def build(related):
        if related:
            base = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
            table = np.broadcast_to(base, (n_eps, n_pad)).copy()
        else:
            table = rng.integers(
                0, 2**32, size=(n_eps, n_pad), dtype=np.uint32
            )
        vtab = np.zeros((n_eps, n_pad), bool)
        vtab[:, 1:120] = True
        return table, vtab

    work = []
    p = 0
    for a in range(n_eps):
        for b in range(a + 1, n_eps):
            work.append((p, a, b))
            p += 1
    assert len(work) > 2048
    slot = {e: e for e in range(n_eps)}

    table, vtab = build(related=True)
    kept, n_skip, w = pf.prefilter_pairs(
        table, vtab, work, slot, lambda _: ts_lm, 10, n_pad
    )
    assert w == 8 and n_skip == 0 and kept == work

    table, vtab = build(related=False)
    kept, n_skip, w = pf.prefilter_pairs(
        table, vtab, work, slot, lambda _: ts_lm, 10, n_pad
    )
    assert w == 8 and n_skip > len(work) * 0.9


# -- band-level masks --------------------------------------------------------


def _mk_pair(rng, n_pad, run_at, run_len):
    """src/dst with one planted shared run on a known diagonal."""
    shared = rng.integers(0, 2**32, size=run_len, dtype=np.uint32)
    src = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
    i0, j0 = run_at
    src[i0 : i0 + run_len] = shared
    dst[j0 : j0 + run_len] = shared
    return src, dst


def _band_masks_for(src, dst, nv, mv, lm, thr, n_pad):
    table = np.stack([src, dst])
    vtab = np.zeros((2, n_pad), bool)
    vtab[0, 1:nv] = True
    vtab[1, 1:mv] = True
    work = [(0, 0, 1)]
    kept, masks, n_skipped, w = pf.prefilter_band_masks(
        jnp_asarray(table), jnp_asarray(vtab), work, {0: 0, 1: 1},
        lambda p: lm, thr, n_pad,
    )
    return table, vtab, kept, masks, n_skipped, w


def jnp_asarray(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


@pytest.mark.parametrize("run_at", [(100, 1400), (1400, 100), (700, 730)])
def test_band_masked_counts_equal_unmasked(rng, monkeypatch, run_at):
    """The kernel with band masks must produce EXACTLY the counts of the
    full walk — the masks only clear provably run-free row blocks."""
    from needle_tpu.search.geometry import full_block_mask, n_groups_for
    from needle_tpu.search.triton_walk import batch_counts

    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad, lm, thr = 2560, 40, 8
    src, dst, = _mk_pair(rng, n_pad, run_at, 60)
    nv = mv = n_pad
    table, vtab, kept, masks, n_skipped, w = _band_masks_for(
        src, dst, nv, mv, lm, thr, n_pad
    )
    assert kept == [(0, 0, 1)] and n_skipped == 0
    n_groups = n_groups_for(n_pad)
    assert masks.shape == (1, n_groups)
    # the mask must actually prune: strictly fewer bits than the full walk
    full = int(full_block_mask(n_pad))
    assert bin(int(masks[0, 0]) & full).count("1") + bin(
        int(masks[0, 1]) & full
    ).count("1") < 2 * bin(full).count("1")

    args = (
        np.array([nv], np.int32), np.array([mv], np.int32),
        np.array([lm], np.int32), np.array([thr], np.int32),
        src[None], dst[None], n_pad,
    )
    got = np.asarray(batch_counts(*args, bm=masks, interpret=True))
    want = np.asarray(batch_counts(*args, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert want.sum() >= 1  # the planted run is found


def test_band_mask_zero_pair_is_dropped(rng, monkeypatch):
    """A pair with no qualifying run anywhere gets an all-zero mask and is
    dropped from the work list (subsumes the pair-level skip)."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad, lm, thr = 2560, 40, 8
    src = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
    dst = rng.integers(0, 2**32, size=n_pad, dtype=np.uint32)
    table, vtab, kept, masks, n_skipped, w = _band_masks_for(
        src, dst, n_pad, n_pad, lm, thr, n_pad
    )
    assert kept == [] and n_skipped == 1 and len(masks) == 0


def test_dense_band_masks_equal_per_pair(rng, monkeypatch):
    """The episode-factorized tile path must produce BIT-IDENTICAL masks
    to the per-pair chunked path (same integer dots, same bound, same
    member fold) — including with overlapping tail tiles (e_pad not a
    multiple of the tile size)."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TA", "4")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_TB", "4")
    n_pad, lm, thr = 1024, 40, 8
    n_eps = 9  # 9 % 4 != 0 -> clamped, overlapping tail tiles
    shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    for e in range(0, n_eps, 2):  # every even episode shares a run
        table[e, 100 + 7 * e : 160 + 7 * e] = shared
    vtab = np.zeros((n_eps, n_pad), bool)
    for e in range(n_eps):
        vtab[e, 1 : 900 + 10 * e] = True
    work = [(p, a, b) for p, (a, b) in enumerate(
        (a, b) for a in range(n_eps) for b in range(a + 1, n_eps)
    )]
    slot = {e: e for e in range(n_eps)}

    def masks_with(mode):
        monkeypatch.setenv("NEEDLE_TPU_PREFILTER_DENSE", mode)
        return pf.prefilter_band_masks(
            table, vtab, work, slot, lambda p: lm, thr, n_pad
        )

    kept_pp, masks_pp, skip_pp, w_pp = masks_with("off")
    kept_d, masks_d, skip_d, w_d = masks_with("on")
    assert w_pp == w_d and skip_pp == skip_d and kept_pp == kept_d
    np.testing.assert_array_equal(masks_pp, masks_d)
    assert skip_pp > 0  # odd-episode pairs share nothing: some skipping
    assert len(kept_pp) > 0  # even-episode pairs survive


def test_dense_gate_sparse_work_uses_per_pair(rng, monkeypatch):
    """auto mode: a sparse work list (few pairs over many episodes) must
    NOT take the tile path — rectangles would compute mostly unneeded
    pairs. Verified by counting _tile_band_masks invocations."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.delenv("NEEDLE_TPU_PREFILTER_DENSE", raising=False)
    calls = []
    real = pf._tile_band_masks
    monkeypatch.setattr(
        pf, "_tile_band_masks",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )
    n_pad, n_eps = 512, 64
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    vtab = np.ones((n_eps, n_pad), bool)
    vtab[:, 0] = False
    slot = {e: e for e in range(n_eps)}
    sparse_work = [(0, 0, 63)]  # one far-apart pair
    pf.prefilter_band_masks(
        table, vtab, sparse_work, slot, lambda p: 81, 10, n_pad
    )
    assert not calls, "tile path ran on a sparse work list"
    # dense all-pairs work over the same episodes takes the tile path
    dense_work = [(p, a, b) for p, (a, b) in enumerate(
        (a, b) for a in range(n_eps) for b in range(a + 1, n_eps)
    )]
    pf.prefilter_band_masks(
        table, vtab, dense_work, slot, lambda p: 81, 10, n_pad
    )
    assert calls, "tile path did not run on a dense work list"


def test_band_masks_long_bucket_returns_none(rng, monkeypatch):
    """Buckets with n_blocks > 31 can't be covered by an i32 bitmask:
    prefilter_band_masks must bail out (returning the untouched work
    list) BEFORE any device work."""
    from needle_tpu.search.geometry import D_TILE

    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    n_pad = 32 * D_TILE  # n_blocks = 33 > 31
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    vtab = np.ones((2, n_pad), bool)
    vtab[:, 0] = False
    work = [(0, 0, 1)]
    kept, masks, n_skipped, w = pf.prefilter_band_masks(
        table, vtab, work, {0: 0, 1: 1}, lambda p: 81, 10, n_pad
    )
    assert kept == work and masks is None and n_skipped == 0 and w is None


def test_pallas_path_falls_back_to_pair_prefilter(rng, monkeypatch):
    """When band masks are inapplicable (simulating the n_blocks > 31
    long-bucket case), the Triton path must still run the pair-level
    skip: cross-show pairs get skipped and results stay identical to the
    numpy engine."""
    from needle_tpu.search import jax_impl as S
    from needle_tpu.search import triton_walk
    from needle_tpu.tracing import metrics

    monkeypatch.setattr(S, "_KERNEL", "triton")
    monkeypatch.setattr(triton_walk, "INTERPRET", True)
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    # simulate the inapplicable-band condition regardless of n_pad
    monkeypatch.setattr(
        pf,
        "prefilter_band_masks",
        lambda table_d, vtab_d, work, *a, **k: (work, None, 0, None),
    )

    shared_a = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    shared_b = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for show, shared in ((0, shared_a), (1, shared_b)):
        for e in range(2):
            h = rng.integers(0, 2**32, size=400, dtype=np.uint32)
            at = 30 + 40 * e
            h[at : at + 120] = shared
            fhs.append(_fh(h))

    before = metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
    got = _run(fhs, 10, 20, "jax")
    skipped = (
        metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
        - before
    )
    assert got == _run(fhs, 10, 20, "numpy")
    # the 4 cross-show pairs are skippable by the pair-level fallback
    assert skipped >= 2, f"pair-level fallback skipped only {skipped}"
    assert got[0] is not None


@pytest.mark.parametrize("dense_mode", ["off", "on"])
def test_engine_band_prefilter_matches_numpy(rng, monkeypatch, dense_mode):
    """Full engine with the Triton walk + band prefilter FORCED on must
    match the reference-exact numpy engine on a mixed library — with the
    band masks computed by either the per-pair or the episode-tile path."""
    from needle_tpu import Comparator
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration
    from needle_tpu.search import jax_impl as S
    from needle_tpu.search import triton_walk

    monkeypatch.setattr(S, "_KERNEL", "triton")
    monkeypatch.setattr(triton_walk, "INTERPRET", True)
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_PREFILTER_DENSE", dense_mode)

    step = 247619033
    shared_a = rng.integers(0, 2**32, size=70, dtype=np.uint32)
    shared_b = rng.integers(0, 2**32, size=80, dtype=np.uint32)
    fhs = []
    for e in range(6):
        h = rng.integers(0, 2**32, size=320 + 30 * e, dtype=np.uint32)
        # two shows: episodes 0-2 share A, 3-5 share B (cross-show pairs
        # should be mask-zero skipped)
        sh = shared_a if e < 3 else shared_b
        h[20 + 13 * e : 20 + 13 * e + len(sh)] = sh
        ts = (2600090703 + np.arange(len(h)) * step).astype(np.int64)
        fhs.append(FrameHashes(h, ts, np.zeros(0, np.uint32),
                               np.zeros(0, np.int64),
                               Duration.from_millis(300), f"{e:032x}"))

    def run(engine):
        cmp = Comparator.from_files(
            [f"q{k}.mkv" for k in range(6)], engine=engine
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
