"""Property test: the batched device search engine must produce EXACTLY the
reference-oracle results on randomized and adversarial hash libraries —
including degenerate inputs that stress the count/bitmask compaction
(identical episodes, constant hashes, many runs per diagonal)."""

import numpy as np
import pytest

from needle_tpu import Comparator
from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration


def _fh(h, hash_ms=300):
    h = np.asarray(h, dtype=np.uint32)
    step = 247619033
    ts = (2600090703 + np.arange(len(h)) * step).astype(np.int64)
    return FrameHashes(
        h, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64),
        Duration.from_millis(hash_ms), "f" * 32,
    )


def _run(fhs, threshold, min_open_s, engine):
    cmp = (
        Comparator.from_files([f"v{k}.mkv" for k in range(len(fhs))], engine=engine)
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


def test_randomized_libraries_match_oracle(rng):
    for trial in range(6):
        n_eps = int(rng.integers(2, 5))
        lens = rng.integers(60, 400, size=n_eps)
        shared_len = int(rng.integers(20, 60))
        shared = rng.integers(0, 2**32, size=shared_len, dtype=np.uint32)
        fhs = []
        for e in range(n_eps):
            h = rng.integers(0, 2**32, size=int(lens[e]), dtype=np.uint32)
            if lens[e] > shared_len + 2:
                at = int(rng.integers(1, lens[e] - shared_len))
                h[at : at + shared_len] = shared
                # sprinkle near-matches: flip a few bits inside the run
                flips = rng.integers(0, shared_len, size=3)
                h[at + flips] ^= np.uint32(1) << rng.integers(
                    0, 32, size=3
                ).astype(np.uint32)
            fhs.append(_fh(h))
        threshold = int(rng.integers(0, 16))
        min_open = int(rng.integers(2, 12))
        assert _run(fhs, threshold, min_open, "jax") == _run(
            fhs, threshold, min_open, "numpy"
        ), f"trial {trial} diverged"


def test_identical_episodes_every_diagonal_matches(rng):
    """Two byte-identical episodes: the zero-offset diagonal is a full-length
    run and EVERY other diagonal may also match by chance — worst case for
    the device compaction."""
    h = rng.integers(0, 2**32, size=200, dtype=np.uint32)
    fhs = [_fh(h), _fh(h.copy())]
    assert _run(fhs, 10, 5, "jax") == _run(fhs, 10, 5, "numpy")


def test_constant_hashes_multiple_runs_per_diagonal():
    """Constant hash values with gaps create multiple >=min runs on ONE
    diagonal — exactly the case the per-diagonal host rescan must recover."""
    h1 = np.zeros(300, np.uint32)
    h2 = np.zeros(300, np.uint32)
    h1[100] = 0xFFFFFFFF  # break the run in src only
    h2[210] = 0xFFFFFFFF
    fhs = [_fh(h1), _fh(h2)]
    assert _run(fhs, 0, 3, "jax") == _run(fhs, 0, 3, "numpy")


def test_tiny_and_empty_sequences():
    fhs = [_fh(np.zeros(1, np.uint32)), _fh(np.zeros(5, np.uint32))]
    assert _run(fhs, 5, 1, "jax") == _run(fhs, 5, 1, "numpy")


def test_compaction_on_off_and_overflow_agree(rng, monkeypatch):
    """Flagged-diagonal compaction (download bit indices instead of the
    full count bitmask) must produce identical results with compaction
    off, on, and with a tiny cap that forces the per-chunk full-bitmask
    overflow fallback (identical episodes flag EVERY diagonal)."""
    shared = rng.integers(0, 2**32, size=80, dtype=np.uint32)
    fhs = []
    for e in range(4):
        h = rng.integers(0, 2**32, size=300, dtype=np.uint32)
        h[10:90] = shared
        fhs.append(_fh(h))
    # two identical episodes: every diagonal cell of their pair matches,
    # flooding the flag bitmask (worst case for the index cap)
    const = _fh(np.full(300, 0x12345678, np.uint32))
    fhs.extend([const, const])

    from needle_tpu.tracing import metrics

    outs = []
    for flags_env, cap_env in (("0", None), ("1", None), ("1", "64")):
        monkeypatch.setenv("NEEDLE_TPU_COMPACT_FLAGS", flags_env)
        if cap_env is None:
            monkeypatch.delenv("NEEDLE_TPU_COMPACT_CAP", raising=False)
        else:
            monkeypatch.setenv("NEEDLE_TPU_COMPACT_CAP", cap_env)
        before = metrics.snapshot().get(
            "search.collect_compact_overflow", (0.0, 0)
        )[0]
        outs.append(_run(fhs, 10, 5, "jax"))
        overflowed = (
            metrics.snapshot().get(
                "search.collect_compact_overflow", (0.0, 0)
            )[0]
            - before
        )
        if cap_env is not None:
            # the tiny cap must actually exercise the fallback
            assert overflowed >= 1, "overflow fallback never fired"
    assert outs[0] == outs[1] == outs[2]
    assert any(o is not None for o in outs[0])


def test_prefilter_skips_do_not_misalign_hash_durations(rng, monkeypatch):
    """Regression: _entries_batch consumed episode-id arrays
    built from the PRE-prefilter work list, so any prefilter-skipped pair
    shifted every later pair onto the WRONG episodes' hash durations —
    latent while all files share one hash duration, wrong end times when
    they differ. Episode 0 is noise (its pairs are prefilter-skipped, so
    the surviving pair's work-row index differs from its original
    position) and carries a different hash duration."""
    monkeypatch.setenv("NEEDLE_TPU_SEARCH_PREFILTER", "on")
    shared = rng.integers(0, 2**32, size=80, dtype=np.uint32)
    h1 = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=300, dtype=np.uint32)
    h1[40:120] = shared
    h2[90:170] = shared
    fhs = [
        _fh(rng.integers(0, 2**32, size=300, dtype=np.uint32), hash_ms=300),
        _fh(h1, hash_ms=500),
        _fh(h2, hash_ms=500),
    ]
    got = _run(fhs, 10, 5, "jax")
    want = _run(fhs, 10, 5, "numpy")
    assert got == want
