"""Self-test for tools/check_golden.py: the verifier
must pass on files our own analyzer persists (under BOTH candidate
timestamp encodings, detecting each), and fail loudly on corruption."""

import os
import sys
from pathlib import Path

import numpy as np
import pytest

import needle_tpu as needle
from needle_tpu.data import frame_hash_data_path
from needle_tpu.testing import make_synthetic_season

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import check_golden  # noqa: E402


def _persist_one(tmp_path, ts_mode, monkeypatch, endings=False):
    monkeypatch.setenv("NEEDLE_TPU_TS_MODE", ts_mode)
    paths, _, _ = make_synthetic_season(
        tmp_path,
        num_episodes=1,
        episode_secs=240,
        opening_secs=25,
        ending_secs=30.0 if endings else 0.0,
        seed=9,
    )
    a = needle.Analyzer.from_files(paths, force=True).with_include_endings(
        endings
    )
    a.run(needle.Duration.from_secs_f32(np.float32(0.3)), persist=True)
    monkeypatch.delenv("NEEDLE_TPU_TS_MODE")
    return paths[0], frame_hash_data_path(paths[0])


@pytest.mark.parametrize("ts_mode", ["samples", "ms"])
def test_check_golden_green_and_mode_detected(tmp_path, ts_mode, monkeypatch):
    video, dat = _persist_one(tmp_path, ts_mode, monkeypatch, endings=True)
    report = check_golden.check(dat, video)
    assert report["decode"]["ok"]
    assert report["roundtrip"]["ok"]
    assert report["ts_mode"]["mode"] == ts_mode
    # the rejected mode must be visibly far off (~0.81 ms/hash drift)
    other = "ms" if ts_mode == "samples" else "samples"
    assert report["ts_mode"]["deviation_ns"][other] > 10_000
    assert report["md5"]["ok"]
    assert report["hashes"]["ok"]
    assert report["hashes"]["analyzed_under_ts_mode"] == ts_mode
    assert report["ok"]


def test_check_golden_flags_corruption(tmp_path, monkeypatch):
    video, dat = _persist_one(tmp_path, "samples", monkeypatch)
    raw = bytearray(dat.read_bytes())
    raw[3] ^= 0xFF  # clobber the version variant index
    bad = tmp_path / "bad.needle.dat"
    bad.write_bytes(bytes(raw))
    report = check_golden.check(bad, None)
    assert not report["decode"]["ok"]
    assert not report["ok"]


def test_check_golden_flags_timestamp_drift(tmp_path, monkeypatch):
    """A file whose timestamps match NEITHER encoding must not pass."""
    from needle_tpu.data import FrameHashes

    video, dat = _persist_one(tmp_path, "samples", monkeypatch)
    fh = FrameHashes.from_path(dat)
    drifted = FrameHashes(
        fh.opening_hashes,
        fh.opening_ts_nanos + np.arange(len(fh.opening_ts_nanos)) * 5_000_000,
        fh.ending_hashes,
        fh.ending_ts_nanos,
        fh.hash_duration(),
        fh.md5(),
    )
    bad = tmp_path / "drift.needle.dat"
    bad.write_bytes(drifted.to_bytes())
    report = check_golden.check(bad, None)
    assert report["ts_mode"]["mode"] is None
    assert not report["ok"]


def test_check_golden_cli_exit_codes(tmp_path, monkeypatch, capsys):
    import json

    video, dat = _persist_one(tmp_path, "samples", monkeypatch)
    assert check_golden.main([str(dat), str(video)]) == 0
    out_lines = capsys.readouterr().out.strip().splitlines()
    tail = json.loads(out_lines[-1])
    assert tail["golden_check_ok"] is True
    assert tail["ts_mode"] == "samples"
    assert check_golden.main([]) == 2
