"""End-to-end: CLI analyze/search over synthetic seasons and sample videos."""

import json
from pathlib import Path

import numpy as np
import pytest

from needle_tpu.cli import main
from needle_tpu.data import FrameHashes
from needle_tpu.testing import make_synthetic_season


@pytest.fixture(scope="module")
def season(tmp_path_factory):
    d = tmp_path_factory.mktemp("season")
    paths, op_truth, end_truth = make_synthetic_season(
        d, num_episodes=3, episode_secs=120, opening_secs=25, ending_secs=25, seed=42
    )
    return d, paths, op_truth, end_truth


def test_analyze_writes_dat(season):
    d, paths, _, _ = season
    assert main(["analyze", "--include-endings", "--backend", "numpy", str(d)]) == 0
    for p in paths:
        dat = p.with_suffix(".needle.dat")
        fh = FrameHashes.from_path(dat)
        assert len(fh.opening_hashes) > 100
        assert len(fh.ending_hashes) > 50
        # timestamps strictly increasing, starting at chromaprint delay
        assert fh.opening_ts_nanos[0] == 2600090703
        assert (np.diff(fh.opening_ts_nanos) > 0).all()


def test_analyze_cache_skip(season, capsys):
    d, paths, _, _ = season
    main(["analyze", "--include-endings", "--backend", "numpy", str(d)])
    out = capsys.readouterr().out
    assert f"Skipping analysis for {paths[0]}..." in out


def test_search_finds_openings_and_endings(season, capsys):
    d, paths, op_truth, end_truth = season
    assert (
        main(["search", "--include-endings", "--write-skip-files", "--engine", "numpy", str(d)])
        == 0
    )
    out = capsys.readouterr().out
    assert "* Opening - " in out and "* Ending - " in out
    for p, (op_s, op_e), (en_s, en_e) in zip(paths, op_truth, end_truth):
        skip = json.loads(p.with_suffix(".needle.skip.json").read_text())
        got_open = skip["opening"]
        assert got_open is not None
        # openings should bracket the truth within a few seconds (hash
        # granularity ~0.25 s + fuzzy-match extension at the edges)
        assert abs(got_open[0] - op_s) < 8.0
        assert abs(got_open[1] - op_e) < 8.0
        got_end = skip["ending"]
        assert got_end is not None
        assert abs(got_end[0] - en_s) < 8.0
        assert abs(got_end[1] - en_e) < 8.0


def test_search_use_skip_files(season, capsys):
    d, _, _, _ = season
    main(["search", "--include-endings", "--use-skip-files", "--engine", "numpy", str(d)])
    out = capsys.readouterr().out
    assert "Skipping due to existing skip file..." in out


def test_display_format(season, capsys):
    d, paths, _, _ = season
    main(["search", "--include-endings", "--engine", "numpy", str(d)])
    out = capsys.readouterr().out
    # reference format: * Opening - "MM:SSs"-"MM:SSs" (Debug-quoted strings)
    import re

    assert re.search(r'\* Opening - "\d{2,}:\d{2}s"-"\d{2,}:\d{2}s"', out)
    for p in paths:
        assert f"\n{p}\n" in out


def test_backends_agree_end_to_end(tmp_path, chromaprint_available):
    """numpy pipeline and the real libchromaprint pipeline must produce
    byte-identical .dat and skip files through the full CLI."""
    if not chromaprint_available:
        pytest.skip("libchromaprint not installed")
    results = {}
    for backend in ["numpy", "chromaprint"]:
        d = tmp_path / backend
        make_synthetic_season(
            d, num_episodes=3, episode_secs=100, opening_secs=25, ending_secs=22, seed=7
        )
        main(["analyze", "--backend", backend, "--include-endings", str(d)])
        main(["search", "--no-display", "--write-skip-files", "--include-endings", str(d)])
        results[backend] = {
            p.name: p.read_bytes()
            for p in sorted(d.glob("*.needle.*"))
        }
    assert results["numpy"] == results["chromaprint"]


def test_sample_videos_analyze(sample_videos):
    """The reference's bundled 5s samples decode and analyze cleanly."""
    d = sample_videos[0].parent
    assert main(["analyze", "--backend", "numpy", "--force", str(d)]) == 0
    for p in sample_videos:
        fh = FrameHashes.from_path(p.with_suffix(".needle.dat"))
        assert fh.md5() is not None


def test_cli_validation(tmp_path, capsys):
    with pytest.raises(SystemExit):
        main(["analyze", "--opening-search-percentage", "1.5", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["analyze", "--hash-duration", "0", str(tmp_path)])
    with pytest.raises(SystemExit):
        main(["search", "--hash-match-threshold", "33", str(tmp_path)])
    # fewer than 2 videos
    (tmp_path / "only.wav").write_bytes(b"RIFF")
    with pytest.raises(SystemExit):
        main(["search", str(tmp_path / "only.wav")])


def test_sample_videos_endings_and_seek(sample_videos):
    """The AV ending path: bounded seek (keyframe fallback included) and
    reference semantics for too-short files (empty ending data, clean
    search error)."""
    from needle_tpu import ingest
    from needle_tpu.data import FrameHashes

    d = sample_videos[0].parent
    assert main(
        ["analyze", "--backend", "numpy", "--include-endings", "--force", str(d)]
    ) == 0
    for p in sample_videos:
        fh = FrameHashes.from_path(p.with_suffix(".needle.dat"))
        # sample-5s has ~2.9 s of opening-window audio (1 hash); the shifted
        # variant's audio starts ~4 s in, so its opening window may be empty
        if p.name == "sample-5s.mp4":
            assert len(fh.opening_hashes) > 0
        # ~5 s of audio: the 25% ending window is too short for any hash
        assert len(fh.ending_hashes) == 0

    # seek beyond duration mirrors the reference's assertion as a clean error
    with pytest.raises(ingest.SeekPastEnd):
        ingest.decode_audio(sample_videos[0], seek_to_secs=4.9)

    # search --include-endings on empty ending data errors cleanly
    with pytest.raises(SystemExit):
        main(["search", "--include-endings", "--engine", "numpy", str(d)])


def test_search_with_inplace_analyze(tmp_path, capsys):
    """`search --analyze` runs the analysis in place (force, not persisted)
    instead of loading .needle.dat (comparator.rs:637-663, data.rs:121-140)."""
    make_synthetic_season(
        tmp_path, num_episodes=3, episode_secs=100, opening_secs=25, seed=77
    )
    assert main(["search", "--analyze", "--engine", "numpy", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "* Opening - " in out
    # in-place analysis must NOT persist hash data
    assert list(tmp_path.glob("*.needle.dat")) == []


def test_search_analyze_uses_batched_pipeline(tmp_path, monkeypatch):
    """Comparator.run(analyze=True) routes ALL videos through the Analyzer's
    batched device pipeline in one pass — never N serial run_single calls
    (the batched rearchitecture of comparator.rs:650-654) — with results
    identical to the per-video path."""
    from needle_tpu import Comparator
    from needle_tpu.analyzer import Analyzer
    from needle_tpu.data import FrameHashes

    make_synthetic_season(
        tmp_path, num_episodes=3, episode_secs=100, opening_secs=25, seed=78
    )
    paths = sorted(
        p for p in tmp_path.iterdir() if not p.name.endswith(".json")
    )

    # per-video reference results (the old path)
    per_video = [FrameHashes.from_video(p, analyze=True) for p in paths]

    batched_calls = []
    orig = Analyzer._run_batched

    def spy(self, *a, **k):
        batched_calls.append(len(self.videos))
        return orig(self, *a, **k)

    monkeypatch.setattr(Analyzer, "_run_batched", spy)
    monkeypatch.setattr(
        Analyzer,
        "run_single",
        lambda *a, **k: pytest.fail("run_single called from search --analyze"),
    )
    cmp = Comparator.from_files(paths, engine="jax")
    res = cmp.run(
        analyze=True, display=False, use_skip_files=False,
        write_skip_files=False,
    )
    assert batched_calls == [len(paths)]
    assert any(r.opening is not None for r in res)
    assert list(tmp_path.glob("*.needle.dat")) == []

    # identical hashes to the per-video in-place path
    monkeypatch.undo()
    analyzer = Analyzer(list(paths)).with_force(True)
    from needle_tpu.constants import DEFAULT_HASH_DURATION
    from needle_tpu.duration import Duration

    batched = analyzer.run(
        Duration.from_secs_f32(DEFAULT_HASH_DURATION), persist=False
    )
    for b, s in zip(batched, per_video):
        np.testing.assert_array_equal(b.opening_hashes, s.opening_hashes)
        np.testing.assert_array_equal(b.opening_ts_nanos, s.opening_ts_nanos)
