"""Discovery semantics: the reference accepts only files with a video
stream (util.rs:22-53). Audio-only inputs (.wav/.pcm/.raw) are a
needle-tpu extension gated behind NEEDLE_TPU_ALLOW_AUDIO (default OFF:
the extension must not silently diverge from reference discovery for a
drop-in replacement)."""

import numpy as np

from needle_tpu import util
from needle_tpu.testing import make_synthetic_season


def _make_wav_season(tmp_path):
    paths, _, _ = make_synthetic_season(
        tmp_path, num_episodes=2, episode_secs=60, opening_secs=10, seed=3
    )
    return paths


def test_audio_only_rejected_by_default(tmp_path, monkeypatch):
    monkeypatch.delenv("NEEDLE_TPU_ALLOW_AUDIO", raising=False)
    _make_wav_season(tmp_path)
    assert not util.allow_audio_only_files()
    assert util.find_video_files([tmp_path]) == []
    wav = next(tmp_path.glob("*.wav"))
    assert not util.is_valid_video_file(wav)


def test_audio_only_accepted_with_knob(tmp_path, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    paths = _make_wav_season(tmp_path)
    found = sorted(util.find_video_files([tmp_path]))
    assert found == sorted(paths)
    # raw PCM too
    pcm = tmp_path / "ep.pcm"
    np.zeros(16000, np.int16).tofile(pcm)
    assert util.is_valid_video_file(pcm)


def test_needle_dat_always_rejected(tmp_path, monkeypatch):
    monkeypatch.setenv("NEEDLE_TPU_ALLOW_AUDIO", "1")
    dat = tmp_path / "ep01.needle.dat"
    dat.write_bytes(b"\x00" * 64)
    assert not util.is_valid_video_file(dat)


def test_video_files_found_regardless_of_knob(tmp_path, monkeypatch):
    """Real video containers (native-muxed fixture) pass discovery with
    the extension OFF — the knob only affects audio-only inputs."""
    import pytest

    from needle_tpu import ingest

    if not ingest.native_available():
        pytest.skip("native ingest unavailable")
    monkeypatch.delenv("NEEDLE_TPU_ALLOW_AUDIO", raising=False)
    rate = 8000
    pcm = np.zeros(rate * 2, np.int16)
    p = tmp_path / "clip.mkv"
    ingest.write_media(p, pcm, rate, 1, codec="pcm_s16le", with_video=True)
    assert util.is_valid_video_file(p)
    assert util.find_video_files([tmp_path]) == [p]
