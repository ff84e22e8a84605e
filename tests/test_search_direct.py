"""Direct diagonal flagging: the matmul block correlation pins each
qualifying run's diagonal, superseding the count-kernel walk. These tests
pin (a) the flagged set covers every planted run's diagonal, (b) the full
engine in direct mode is byte-identical to the reference-exact numpy
engine and to the classic walk, including the weakest-qualifying
adversarial cases, and (c) the auto gate only engages on dense work."""

import numpy as np
import pytest

from needle_tpu.search import prefilter as pf


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


def test_direct_items_cover_planted_diagonals(rng, monkeypatch):
    """Every planted run's diagonal must appear in the flagged set for
    its pair (the superset guarantee), at several offsets including
    negative and near-boundary diagonals."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    n_pad, lm, thr = 1024, 40, 8  # w = 16
    plants = [(100, 900), (900, 100), (700, 716), (1, 500)]
    table = rng.integers(0, 2**32, size=(8, n_pad), dtype=np.uint32)
    vtab = np.zeros((8, n_pad), bool)
    vtab[:, 1:1000] = True
    work = []
    for p, (i0, j0) in enumerate(plants):
        a, b = 2 * p, 2 * p + 1
        shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
        table[a, i0 : i0 + 60] = shared
        table[b, j0 : j0 + 60] = shared
        work.append((p, a, b))
    slot = {e: e for e in range(8)}
    items = pf.direct_diag_items(
        table, vtab, work, slot, lambda p: lm, thr, n_pad
    )
    assert items is not None
    rows, offs = items
    for p, (i0, j0) in enumerate(plants):
        d = j0 - i0
        got = offs[rows == p]
        assert d in got, f"pair {p}: diagonal {d} not flagged (got {got})"


def test_direct_items_none_for_runless_pairs(rng, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    n_pad = 1024
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    vtab = np.zeros((2, n_pad), bool)
    vtab[:, 1:1000] = True
    rows, offs = pf.direct_diag_items(
        table, vtab, [(0, 0, 1)], {0: 0, 1: 1}, lambda p: 40, 8, n_pad
    )
    assert len(rows) == 0 and len(offs) == 0


@pytest.mark.parametrize("engine_seed", [3, 11])
def test_engine_direct_matches_numpy_and_walk(rng, monkeypatch, engine_seed):
    """Full engine with direct mode FORCED must match both the numpy
    engine and the classic walk on a mixed library with bit-flipped
    shared runs."""
    r = np.random.default_rng(engine_seed)
    shared_a = r.integers(0, 2**32, size=120, dtype=np.uint32)
    shared_b = r.integers(0, 2**32, size=90, dtype=np.uint32)
    fhs = []
    for show, shared in ((0, shared_a), (1, shared_b)):
        for e in range(3):
            h = r.integers(0, 2**32, size=300 + 40 * e, dtype=np.uint32)
            at = 25 + 30 * e
            h[at : at + len(shared)] = shared
            flips = r.integers(0, len(shared), size=6)
            h[at + flips] ^= np.uint32(1) << r.integers(
                0, 32, size=6
            ).astype(np.uint32)
            fhs.append(_fh(h))
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    direct = _run(fhs, 10, 20, "jax")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "off")
    walk = _run(fhs, 10, 20, "jax")
    assert direct == walk == _run(fhs, 10, 20, "numpy")
    assert any(g is not None for g in direct)


def test_engine_direct_weakest_qualifying_run(monkeypatch):
    """A run at EXACTLY l_min cells, every cell at EXACTLY the hamming
    threshold — zero slack against both the block bound and the run
    filter — must survive direct mode identically."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    rng = np.random.default_rng(7)
    n = 400
    thr, min_open_s = 10, 20
    run = rng.integers(0, 2**32, size=81, dtype=np.uint32)  # l_min = 81
    h1 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    h1[37 : 37 + 81] = run
    noisy = run.copy()
    for k in range(81):
        bits = rng.choice(32, size=thr, replace=False)
        for b in bits:
            noisy[k] ^= np.uint32(1) << np.uint32(b)
    h2[160 : 160 + 81] = noisy
    fhs = [_fh(h1), _fh(h2)]
    got = _run(fhs, thr, min_open_s, "jax")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "off")
    assert got == _run(fhs, thr, min_open_s, "jax")
    assert got == _run(fhs, thr, min_open_s, "numpy")
    assert got[0] is not None


def test_direct_auto_gate(rng, monkeypatch):
    """auto: sparse work (1 far pair over many slots) must NOT take the
    direct path; a plan-less work list (threshold too loose) must not
    either; forced on always does when the plan applies."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.delenv("NEEDLE_TPU_SEARCH_DIRECT", raising=False)
    n_pad, n_eps = 512, 256
    table = rng.integers(0, 2**32, size=(n_eps, n_pad), dtype=np.uint32)
    vtab = np.ones((n_eps, n_pad), bool)
    vtab[:, 0] = False
    slot = {e: e for e in range(n_eps)}
    assert (
        pf.direct_diag_items(
            table, vtab, [(0, 0, 255)], slot, lambda p: 81, 10, n_pad
        )
        is None
    )
    # threshold >= 16: plan inapplicable even when forced
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    assert (
        pf.direct_diag_items(
            table, vtab, [(0, 0, 255)], slot, lambda p: 81, 16, n_pad
        )
        is None
    )


def test_direct_overflow_redispatch(rng, monkeypatch):
    """A pathologically self-similar pair (constant hashes: every
    diagonal qualifies) must overflow the tile cap and re-dispatch with
    a bigger one, still returning the complete flag set."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_DIRECT", "on")
    monkeypatch.setenv("NEEDLE_TPU_DIRECT_CAP", "64")
    n_pad = 512
    table = np.full((2, n_pad), 0x12345678, np.uint32)
    vtab = np.zeros((2, n_pad), bool)
    vtab[:, 1:500] = True
    rows, offs = pf.direct_diag_items(
        table, vtab, [(0, 0, 1)], {0: 0, 1: 1}, lambda p: 40, 8, n_pad
    )
    # every diagonal with room for a qualifying block must be flagged;
    # certainly more than the 64-entry cap
    assert len(rows) > 64
    assert 0 in offs and (rows == 0).all()


def test_dense_tile_plan_contract(rng):
    """The plan is the single source of truth for tile assembly: bounds
    has len(uniq)+1 entries, every work row lands in exactly one tile
    segment, and each row's slots fall inside its tile's clamped origin
    window (including overlapping tail tiles)."""
    e_pad = 100  # not a multiple of either tile size: tail tiles clamp
    n = 5000
    sa = rng.integers(0, e_pad, n).astype(np.int32)
    sb = rng.integers(0, e_pad, n).astype(np.int32)
    ta_sz, tb_sz, uniq, order, bounds, origins = pf._dense_tile_plan(
        sa, sb, e_pad
    )
    assert len(bounds) == len(uniq) + 1
    assert len(origins) == len(uniq)
    assert bounds[0] == 0 and bounds[-1] == n
    seen = np.concatenate(
        [order[bounds[t] : bounds[t + 1]] for t in range(len(uniq))]
    )
    assert sorted(seen.tolist()) == list(range(n))
    for t, (a0, b0) in enumerate(origins):
        idx = order[bounds[t] : bounds[t + 1]]
        assert a0 >= 0 and b0 >= 0
        assert a0 + ta_sz <= e_pad and b0 + tb_sz <= e_pad
        assert np.all((sa[idx] - a0 >= 0) & (sa[idx] - a0 < ta_sz))
        assert np.all((sb[idx] - b0 >= 0) & (sb[idx] - b0 < tb_sz))


def test_initial_cap_derivation():
    """2 words per densest-tile cell, pow2-bucketed, floored and clamped."""
    # floor
    assert pf._initial_cap(1, 16, 128) == 1024
    assert pf._initial_cap(500, 16, 128) == 1024
    # pow2 ceiling of 2*seg_max
    assert pf._initial_cap(2048, 16, 128) == 4096
    assert pf._initial_cap(2049, 16, 128) == 8192
    # clamp at the tile-area bound
    assert pf._initial_cap(10**9, 16, 128) == 8 * 16 * 128
