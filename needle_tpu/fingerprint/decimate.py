"""Host-side band-limited decimation before device upload.

Chromaprint's chroma fold only consumes spectral bins up to ~3520 Hz
(constants.chroma_bin_ranges), so any representation with >= ~8 kHz sample
rate carries every bit of information the fingerprint uses. Where
host->device bandwidth is the analyze bottleneck, decimating
16 kHz/44.1 kHz/48 kHz sources by an integer factor on host (a cheap
polyphase FIR) halves-to-quarters the uploaded bytes with no effect on
which chroma content the device sees; the device's polyphase resampler
then takes the decimated rate to 11025 Hz as usual.

The FIR is linear-phase with its group delay compensated, so output sample
k sits exactly at input time k*f — timestamps are unaffected.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# Highest chroma band edge (constants.chroma_bin_ranges: bins up to
# ~3520 Hz) plus transition headroom.
_MIN_RATE = 8000


def _half_taps(f: int) -> int:
    """FIR half-width, rounded up to a multiple of f so the linear-phase
    group delay (H input samples) trims to an EXACT number of output
    samples — otherwise every output is shifted by H mod f inputs."""
    return -(-32 // f) * f


def decimation_factor(in_rate: int) -> int:
    """Largest small integer factor keeping the decimated rate >= 8 kHz."""
    for f in (4, 3, 2):
        if in_rate % f == 0 and in_rate // f >= _MIN_RATE:
            return f
    return 1


@functools.lru_cache(maxsize=8)
def _fir(in_rate: int, f: int) -> np.ndarray:
    """Anti-alias lowpass for decimation by f: cutoff at the new Nyquist,
    kaiser(9) windowed sinc, 2H+1 taps, unit DC gain."""
    H = _half_taps(f)
    h_idx = np.arange(-H, H + 1, dtype=np.float64)
    fc = 1.0 / (2.0 * f) * 0.94
    taps = 2.0 * fc * np.sinc(2.0 * fc * h_idx)
    taps *= np.kaiser(2 * H + 1, 9.0)
    taps /= taps.sum()
    return taps.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _halfband_q14(n_odd: int, beta: float) -> Tuple[np.ndarray, int]:
    """Half-band lowpass for factor-2 decimation: h[d] = 0.5 sinc(d/2) w[d]
    — every even-offset tap vanishes and the odd taps are symmetric, so the
    native kernel needs n_odd+1 multiplies per output instead of 4*n_odd+1.
    Returns (odd-offset taps 1,3,..,2*n_odd-1 as Q14 int32, center tap Q14),
    DC gain normalized to 1 before quantization.

    Design points: the final stage to ~8-11 kHz uses n_odd=28, beta=9
    (transition ~0.219-0.281 of the input rate: flat through chroma's
    3520 Hz top band at 16 kHz in, stopband before the first alias that
    could fold below it). The relaxed first stage of a factor-4 cascade
    uses n_odd=3, beta=5.65 (only content above ~18 kHz can alias into the
    chroma band after the second stage, so the transition can be huge)."""
    H = 2 * n_odd - 1
    d = np.arange(1, H + 1, 2, dtype=np.float64)
    w = np.kaiser(2 * H + 1, beta)[H + 1 :][d.astype(np.int64) - 1]
    taps = 0.5 * np.sinc(d / 2.0) * w
    center = 0.5
    scale = 1.0 / (center + 2.0 * taps.sum())
    return (
        np.round(taps * scale * 16384.0).astype(np.int32),
        int(round(center * scale * 16384.0)),
    )


_HB_MAIN = (28, 9.0)  # final stage (flat to 3520 Hz at 16 kHz input)
_HB_RELAXED = (3, 5.65)  # first stage of a /4 cascade


def halfband_float_taps(n_odd: int, beta: float) -> np.ndarray:
    """Full symmetric float tap vector of _halfband_q14's design (testing
    oracle for the native kernel)."""
    odd_q, center_q = _halfband_q14(n_odd, beta)
    H = 2 * n_odd - 1
    h = np.zeros(2 * H + 1, dtype=np.float64)
    h[H] = center_q / 16384.0
    for m, q in enumerate(odd_q):
        dd = 2 * m + 1
        h[H - dd] = h[H + dd] = q / 16384.0
    return h


@functools.lru_cache(maxsize=8)
def _fir_q14(in_rate: int, f: int) -> "np.ndarray":
    """The same FIR quantized to Q14 int32 for the native fixed-point
    decimator. The ~1e-4 DC-gain quantization error is a pure global PCM
    scale, which chromaprint's per-frame chroma normalization cancels."""
    return np.round(_fir(in_rate, f).astype(np.float64) * 16384.0).astype(
        np.int32
    )


def host_decimate(
    x: np.ndarray, in_rate: int, channels: int = 1
) -> Tuple[np.ndarray, int]:
    """Decimate interleaved i16 PCM by decimation_factor(in_rate).

    Returns (decimated i16, new_rate); a no-op passthrough when no useful
    factor exists (e.g. already <= 11025 Hz sources).

    Runs through the native fixed-point FIR when available (deterministic
    integer arithmetic, ~20x faster on the 1-core host); otherwise the
    scipy float path (same filter design; outputs may differ by 1 LSB on
    ~1e-4 of samples, which the chroma pipeline absorbs).
    """
    f = decimation_factor(in_rate)
    if f == 1 or len(x) < f * channels:
        return x, in_rate
    from .. import ingest

    if ingest.native_available():
        if f == 2:
            return (
                ingest.decimate2_hb(x, channels, *_halfband_q14(*_HB_MAIN)),
                in_rate // 2,
            )
        if f == 4:
            y = ingest.decimate2_hb(x, channels, *_halfband_q14(*_HB_RELAXED))
            return (
                ingest.decimate2_hb(y, channels, *_halfband_q14(*_HB_MAIN)),
                in_rate // 4,
            )
        out = ingest.decimate_i16(x, channels, f, _fir_q14(in_rate, f))
        return out, in_rate // f
    return host_decimate_scipy(x, in_rate, channels)


def host_decimate_scipy(
    x: np.ndarray, in_rate: int, channels: int = 1
) -> Tuple[np.ndarray, int]:
    """Float-FIR fallback (scipy.signal.upfirdn), same filter design."""
    f = decimation_factor(in_rate)
    if f == 1 or len(x) < f * channels:
        return x, in_rate
    from scipy.signal import upfirdn

    h = _fir(in_rate, f)
    lead = _half_taps(f) // f  # exact: _half_taps(f) is a multiple of f
    if channels == 1:
        y = upfirdn(h, np.asarray(x).astype(np.float32), up=1, down=f)
        y = y[lead : lead + len(x) // f]
        return np.clip(np.rint(y), -32768, 32767).astype(np.int16), in_rate // f
    frames = np.asarray(x).reshape(-1, channels)
    outs = []
    for c in range(channels):
        y = upfirdn(h, frames[:, c].astype(np.float32), up=1, down=f)
        outs.append(y[lead : lead + frames.shape[0] // f])
    out = np.stack(outs, axis=1).reshape(-1)
    return np.clip(np.rint(out), -32768, 32767).astype(np.int16), in_rate // f
