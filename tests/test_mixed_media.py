"""Mixed-media ingestion: stereo sources, 44.1/48 kHz rates, long inputs.

The device-ingest path (downmix + resample + hash fused on the
accelerator, plus the host/device decimation placements) must agree with the
host-swresample path used by the numpy backend for any source layout.
"""

import numpy as np
import pytest

from needle_tpu import Analyzer, Comparator
from needle_tpu.duration import Duration
from needle_tpu.testing import _music_like, write_wav_i16


def _stereo_wav(path, rng, secs, rate, shared=None, shared_at=0.0):
    n = int(secs * rate)
    left = _music_like(rng, n, rate)
    right = 0.8 * left + 0.2 * _music_like(rng, n, rate)
    if shared is not None:
        at = int(shared_at * rate)
        left[at : at + len(shared)] = shared
        right[at : at + len(shared)] = shared
    pcm = np.clip(
        np.stack([left, right], axis=1) * 9000, -32768, 32767
    ).astype(np.int16)
    write_wav_i16(path, pcm.reshape(-1), rate, channels=2)


@pytest.mark.parametrize("rate", [44100, 48000])
def test_stereo_highrate_device_ingest_matches_swr(tmp_path, rng, rate):
    shared = _music_like(rng, int(22 * rate), rate)
    paths = []
    for e in range(2):
        p = tmp_path / f"ep{e}.wav"
        _stereo_wav(p, rng, 90, rate, shared=shared, shared_at=5.0 + 3 * e)
        paths.append(p)

    hd = Duration.from_secs_f32(np.float32(0.3))
    results = {}
    for backend in ("numpy", "jax"):
        fhs = Analyzer.from_files(paths, backend=backend).run(hd, persist=False)
        cmp = Comparator.from_files(paths, engine="numpy")
        res = cmp.run_with_frame_hashes(
            fhs, display=False, use_skip_files=False, write_skip_files=False
        )
        results[backend] = [
            None if r.opening is None else
            (r.opening[0].as_secs_f64(), r.opening[1].as_secs_f64())
            for r in res
        ]
    for a, b in zip(results["numpy"], results["jax"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a[0] - b[0]) < 1.5 and abs(a[1] - b[1]) < 1.5, (a, b)
    assert any(r is not None for r in results["jax"])


def test_decimation_forced_on_and_off_agree(tmp_path, rng, monkeypatch):
    """Hashes found with and without host decimation give the same search
    results (decimation only removes unused spectral content)."""
    rate = 16000
    shared = _music_like(rng, int(26 * rate), rate)
    paths = []
    for e in range(2):
        p = tmp_path / f"d{e}.wav"
        n = int(100 * rate)
        body = _music_like(rng, n, rate)
        at = int((4.0 + 2 * e) * rate)
        body[at : at + len(shared)] = shared
        write_wav_i16(p, np.clip(body * 9000, -32768, 32767).astype(np.int16),
                      rate, 1)
        paths.append(p)

    hd = Duration.from_secs_f32(np.float32(0.3))
    outs = {}
    for flag, tag in (("1", "on"), ("0", "off")):
        monkeypatch.setenv("NEEDLE_TPU_DECIMATE", flag)
        fhs = Analyzer.from_files(paths, backend="jax").run(hd, persist=False)
        res = Comparator.from_files(paths, engine="jax").run_with_frame_hashes(
            fhs, display=False, use_skip_files=False, write_skip_files=False
        )
        outs[tag] = [
            None if r.opening is None else
            (r.opening[0].as_secs_f64(), r.opening[1].as_secs_f64())
            for r in res
        ]
    for a, b in zip(outs["on"], outs["off"]):
        assert (a is None) == (b is None)
        if a is not None:
            # hash-granularity (~0.25 s) agreement between the 8 kHz and
            # 16 kHz ingest paths
            assert abs(a[0] - b[0]) < 0.6 and abs(a[1] - b[1]) < 0.6, (a, b)
    assert any(o is not None for o in outs["on"])


def test_native_decimator_matches_scipy(rng):
    """The native fixed-point FIR decimator tracks the scipy float path
    (same filter design; Q14 tap quantization bounds the deviation to a
    few LSB ≈ -70 dB, far below the chroma pipeline's noise floor) and is
    bit-deterministic across calls."""
    from needle_tpu import ingest
    from needle_tpu.fingerprint.decimate import (
        host_decimate_scipy,
        _fir_q14,
        decimation_factor,
    )

    if not ingest.native_available():
        pytest.skip("native ingest unavailable")

    for rate, channels in ((16000, 1), (44100, 2), (48000, 1)):
        f = decimation_factor(rate)
        assert f > 1
        n = rate * channels  # 1 second
        x = (rng.standard_normal(n) * 9000).astype(np.int16)
        y_native = ingest.decimate_i16(x, channels, f, _fir_q14(rate, f))
        y_scipy, new_rate = host_decimate_scipy(x, rate, channels)
        assert new_rate == rate // f
        assert y_native.shape == y_scipy.shape
        diff = np.abs(y_native.astype(np.int32) - y_scipy.astype(np.int32))
        assert diff.max() <= 8, (rate, channels, diff.max())
        assert diff.mean() < 2.0, (rate, channels, diff.mean())
        # determinism
        y2 = ingest.decimate_i16(x, channels, f, _fir_q14(rate, f))
        np.testing.assert_array_equal(y_native, y2)


def test_halfband_decimator_matches_float_oracle(rng):
    """The native half-band kernel equals a float upfirdn with the SAME
    quantized taps to 1 LSB (rounding only), for mono and stereo."""
    from scipy.signal import upfirdn

    from needle_tpu import ingest
    from needle_tpu.fingerprint.decimate import (
        _HB_MAIN,
        _HB_RELAXED,
        _halfband_q14,
        halfband_float_taps,
    )

    if not ingest.native_available():
        pytest.skip("native ingest unavailable")

    for (n_odd, beta) in (_HB_MAIN, _HB_RELAXED):
        h = halfband_float_taps(n_odd, beta)
        H = 2 * n_odd - 1
        for channels in (1, 2):
            n = 16000 * channels
            x = (rng.standard_normal(n) * 9000).astype(np.int16)
            y = ingest.decimate2_hb(
                x, channels, *_halfband_q14(n_odd, beta)
            )
            frames = x.reshape(-1, channels)
            out_frames = frames.shape[0] // 2
            for c in range(channels):
                # native y[k] = sum_d h[H+d] x[2k+d] = conv(x, h)[2k + H]
                conv = np.convolve(frames[:, c].astype(np.float64), h)
                ref_k = conv[H : H + 2 * out_frames : 2]
                got = y.reshape(-1, channels)[:, c].astype(np.float64)
                assert len(got) == len(ref_k)
                assert np.max(
                    np.abs(got - np.clip(np.round(ref_k), -32768, 32767))
                ) <= 1.0


def test_device_decimator_bit_identical_to_native(rng):
    """The jnp integer half-band decimator equals the native C kernel
    bit-for-bit (same Q14 taps, same rounding/clipping) — the property
    that makes decimation PLACEMENT (host vs device) hash-preserving."""
    import jax.numpy as jnp

    from needle_tpu import ingest
    from needle_tpu.fingerprint.decimate import (
        _HB_MAIN,
        _HB_RELAXED,
        _halfband_q14,
    )
    from needle_tpu.fingerprint.jax_impl import _device_decimate2_hb_i32

    if not ingest.native_available():
        pytest.skip("native ingest unavailable")

    for (n_odd, beta) in (_HB_MAIN, _HB_RELAXED):
        odd, c0 = _halfband_q14(n_odd, beta)
        for channels in (1, 2):
            n = 40001 * channels  # odd frame count exercises the tail
            x = (rng.standard_normal(n) * 20000).astype(np.int16)
            x[:8] = np.array([32767, -32768, 32767, -32768] * 2)[:8]
            y_native = ingest.decimate2_hb(x, channels, odd, c0)
            y_dev = np.asarray(
                _device_decimate2_hb_i32(
                    jnp.asarray(x.reshape(-1, channels).astype(np.int32)),
                    odd, c0,
                )
            ).astype(np.int16)
            np.testing.assert_array_equal(
                y_native.reshape(-1, channels), y_dev
            )


def test_decimation_placement_agrees(tmp_path, rng, monkeypatch):
    """Hashes with decimation on DEVICE vs on HOST agree (identical
    decimated samples; only float-resample fusion noise downstream)."""
    from needle_tpu.fingerprint.jax_impl import fingerprint_ingest_jax_batch
    from needle_tpu.search.oracle import popcount_u32

    rate = 16000
    segs = [
        np.clip(_music_like(rng, rate * 40, rate) * 9000, -32768, 32767
                ).astype(np.int16)
        for _ in range(2)
    ]
    outs = {}
    for mode in ("auto", "host"):
        monkeypatch.setenv("NEEDLE_TPU_DECIMATE", mode)
        if mode == "host":
            from needle_tpu.fingerprint.decimate import host_decimate

            dec = [host_decimate(s, rate, 1) for s in segs]
            outs[mode] = fingerprint_ingest_jax_batch(
                [d for d, _ in dec], dec[0][1], 1
            )
        else:
            outs[mode] = fingerprint_ingest_jax_batch(segs, rate, 1)
    for a, b in zip(outs["auto"], outs["host"]):
        assert a.shape == b.shape
        d = popcount_u32(a ^ b)
        assert d.max() <= 2, d.max()
        assert d.sum() / (32.0 * max(1, len(a))) < 0.005


def test_host_placement_downmixes_stereo(tmp_path, rng, monkeypatch):
    """With NEEDLE_TPU_DECIMATE=host, stereo sources are decimated AND
    downmixed on host (the fused device order is decimate -> downmix, so
    the host integer downmix is bit-identical) — uploads are mono, and
    the resulting hashes exactly match the device placement's."""
    from needle_tpu import ingest

    if not ingest.native_available():
        # without the native integer FIR, host_decimate falls back to
        # scipy (documented ±1 LSB on ~1e-4 samples) and exact equality
        # doesn't hold
        pytest.skip("native ingest unavailable")
    rate = 44100
    p = tmp_path / "stereo_host_dm.wav"
    _stereo_wav(p, rng, 30.0, rate)

    hd = Duration.from_secs_f32(np.float32(0.3))
    outs = {}
    for mode in ("auto", "host"):
        monkeypatch.setenv("NEEDLE_TPU_DECIMATE", mode)
        a = Analyzer.from_files([p], backend="jax")
        if mode == "host":
            seg, nv, _, _, seg_rate, seg_ch, _ = a._raw_segments(p)
            assert seg_ch == 1, "host placement should upload mono"
            assert seg_rate < rate, "host placement should decimate first"
            assert nv == len(seg)
        outs[mode] = a.run(hd, persist=False)[0]
    np.testing.assert_array_equal(
        outs["auto"].opening_hashes, outs["host"].opening_hashes
    )
    np.testing.assert_array_equal(
        outs["auto"].ending_hashes, outs["host"].ending_hashes
    )
