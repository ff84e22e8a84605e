"""Batched JAX/XLA fingerprint pipeline (the device path).

A batched reformulation of the chromaprint TEST2 algorithm (the reference
calls into C++ chromaprint per-sample-stream; needle/src/audio/analyzer.rs:
176-311). Design notes:

  * Framing without gathers: the signal is padded to a multiple of the hop
    (1365) and reshaped to rows; each 4096-sample frame is rows f..f+2 plus
    one sample of row f+3 (4096 = 3*1365 + 1), assembled from 4 shifted
    slices + concat — pure layout ops XLA fuses well.
  * The Hamming window is folded into a real DFT-as-matmul: two (4096 x B)
    matrices (cos/sin, restricted to the B=1298 spectral bins chroma actually
    uses) replace an FFT with large, static, batched matmuls
    (NEEDLE_TPU_SPECTRAL=fft selects jnp.fft instead). FLOPs/frame ~21 MF;
    a 28-episode season is only ~3.5 TF.
  * Chroma fold is a second small matmul; the temporal chroma filter is 5
    shifted adds; normalization is an elementwise rowwise op.
  * The 16 trained classifiers are expressed as ONE (192 x 32) matmul over
    unfolded 16-frame windows (classifier_window_matrix), replacing the
    reference's sequential integral-image walk, followed by threshold
    compares, gray-coding, and bit-packing.

Matmuls run with Precision.HIGHEST (full f32: without it a GPU may compute
them in TF32, about 3 decimal digits, and the rescan margin below would not
hold) so quantized classifier
levels agree with the scalar pipeline except for values within float noise of
a trained threshold (~0.05% of hashes, 1 gray-code bit each; the search
engine's Hamming threshold absorbs these).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .._jax_setup import ensure as _jax_setup_ensure

_jax_setup_ensure()

from .constants import (
    CHROMA_FILTER_COEFFS,
    CHROMA_NORM_THRESHOLD,
    FRAME_SIZE,
    HOP_SIZE,
    MAX_FILTER_WIDTH,
    NUM_BANDS,
    QUANTIZER_THRESHOLDS,
    SAMPLE_RATE,
    WINDOW_SCALE,
    chroma_bin_ranges,
    classifier_window_matrix,
    hamming_window,
)
from .numpy_impl import num_frames, num_subfingerprints

_PREC = jax.lax.Precision.HIGHEST

# log2/atanh-series constants for _accurate_log32 (musl logf's split of ln 2:
# HI has zeroed low mantissa bits so exponent * LN2_HI is exact in f32).
_LN2_HI = np.float32(6.9313812256e-01)
_LN2_LO = np.float32(9.0580006145e-06)
_SQRT2_F32 = np.float32(1.4142135)


def _accurate_log32(x):
    """~2-ulp float32 natural log for strictly-positive normal x.

    The rescan margin (_exact_eps) must bound the whole device-vs-oracle
    value error, so the pipeline does not rely on any device's builtin
    log: decompose x = m * 2^e with m in [sqrt(1/2), sqrt(2)), evaluate
    log(m) = 2 atanh(t), t = (m-1)/(m+1), |t| <= 0.1716 via a 5-term odd
    series (truncation < 4e-10 rel), and recombine with ln 2 split hi/lo.
    Elementwise bit ops + 10 flops on (n_sub, 16)-sized arrays — cost is
    invisible next to the DFT matmuls. Used on every backend so the
    pipeline is one code path (on CPU it matches XLA's log to ~1 ulp)."""
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    e = (bits >> jnp.uint32(23)).astype(jnp.int32) - 127
    m = jax.lax.bitcast_convert_type(
        (bits & jnp.uint32(0x007FFFFF)) | jnp.uint32(0x3F800000), jnp.float32
    )
    big = m > _SQRT2_F32
    m = jnp.where(big, m * jnp.float32(0.5), m)
    e = e + big.astype(jnp.int32)
    t = (m - jnp.float32(1.0)) / (m + jnp.float32(1.0))
    t2 = t * t
    p = jnp.float32(1.0 / 9.0)
    p = p * t2 + jnp.float32(1.0 / 7.0)
    p = p * t2 + jnp.float32(1.0 / 5.0)
    p = p * t2 + jnp.float32(1.0 / 3.0)
    p = p * t2 + jnp.float32(1.0)
    ef = e.astype(jnp.float32)
    return ef * _LN2_HI + (jnp.float32(2.0) * t * p + ef * _LN2_LO)

# 4096 = 3 * 1365 + 1
_ROWS_PER_FRAME = FRAME_SIZE // HOP_SIZE  # 3
_FRAME_REMAINDER = FRAME_SIZE - _ROWS_PER_FRAME * HOP_SIZE  # 1


@functools.lru_cache(maxsize=1)
def _dft_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(windowed cos table, windowed sin table, chroma fold matrix)."""
    min_idx, max_idx, notes = chroma_bin_ranges()
    window = hamming_window(FRAME_SIZE, WINDOW_SCALE)  # float64
    n = np.arange(FRAME_SIZE, dtype=np.float64)[:, None]
    k = np.arange(min_idx, max_idx, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / FRAME_SIZE
    wc = (window[:, None] * np.cos(ang)).astype(np.float32)
    ws = (window[:, None] * -np.sin(ang)).astype(np.float32)
    fold = np.zeros((max_idx - min_idx, NUM_BANDS), dtype=np.float32)
    fold[np.arange(max_idx - min_idx), notes] = 1.0
    return wc, ws, fold


@functools.lru_cache(maxsize=1)
def _classifier_tables() -> Tuple[np.ndarray, np.ndarray]:
    W, _ = classifier_window_matrix()
    return W.astype(np.float32), QUANTIZER_THRESHOLDS.astype(np.float32)


def _frames_from_padded(x: jnp.ndarray, n_frames: int) -> jnp.ndarray:
    """(T,) f32 signal (padded so that rows exist) -> (n_frames, 4096)."""
    n_rows = n_frames + _ROWS_PER_FRAME  # enough rows for slicing below
    rows = x[: n_rows * HOP_SIZE].reshape(n_rows, HOP_SIZE)
    a = rows[:n_frames]
    b = rows[1 : n_frames + 1]
    c = rows[2 : n_frames + 2]
    d = rows[3 : n_frames + 3, :_FRAME_REMAINDER]
    return jnp.concatenate([a, b, c, d], axis=1)


def _pack_bits(gray: jnp.ndarray) -> jnp.ndarray:
    shifts = 2 * (15 - jnp.arange(16, dtype=jnp.uint32))
    vals = gray << shifts[None, :]
    out = vals[:, 0]
    for k in range(1, 16):
        out = out | vals[:, k]
    return out


_device_tables_cache = {}


def _device_tables():
    """DFT/classifier tables uploaded once per process and passed as jit
    ARGUMENTS, so the ~42 MB of tables never bake into the program as
    constants (which slows compiles)."""
    key = "tables"
    if key not in _device_tables_cache:
        wc, ws, fold = _dft_tables()
        W_cls, thresholds = _classifier_tables()
        _device_tables_cache[key] = tuple(
            jax.device_put(t) for t in (wc, ws, fold, W_cls, thresholds)
        )
    return _device_tables_cache[key]


@functools.partial(jax.jit, static_argnames=("n_frames", "with_flags"))
def _fingerprint_core_batched(
    batch_i16, wc, ws, fold, W_cls, thresholds, n_frames, with_flags=False
):
    return jax.vmap(
        lambda x: _fingerprint_core_inline(
            x.astype(jnp.float32), wc, ws, fold, W_cls, thresholds, n_frames,
            with_flags=with_flags,
        )
    )(batch_i16)


import os as _os

# Spectral backend: "matmul" (windowed DFT as two matmuls — default) or
# "fft" (window multiply + jnp.fft.rfft). Both produce f32 energies; which
# is faster depends on the device and compiler, so it is env-switchable for
# benchmarking (NEEDLE_TPU_SPECTRAL=fft).
_SPECTRAL = _os.environ.get("NEEDLE_TPU_SPECTRAL", "matmul")


@functools.lru_cache(maxsize=1)
def _window_np() -> np.ndarray:
    """Hamming window as a host constant (16 KB; embeds in the program)."""
    return hamming_window(FRAME_SIZE, WINDOW_SCALE).astype(np.float32)


def _fingerprint_core_inline(
    mono_f32, wc, ws, fold, W_cls, thresholds, n_frames, with_flags=False,
    with_values=False,
):
    frames = _frames_from_padded(mono_f32, n_frames)
    if _SPECTRAL == "fft":
        min_idx, max_idx, _ = chroma_bin_ranges()
        spec = jnp.fft.rfft(frames * _window_np()[None, :])
        spec = spec[:, min_idx:max_idx]
        energy = spec.real * spec.real + spec.imag * spec.imag
    else:
        re = jnp.dot(frames, wc, precision=_PREC)
        im = jnp.dot(frames, ws, precision=_PREC)
        energy = re * re + im * im
    chroma = jnp.dot(energy, fold, precision=_PREC)
    return _post_chroma(
        chroma, W_cls, thresholds, n_frames, with_flags=with_flags,
        with_values=with_values,
    )


# Borderline margin for the bit-exact rescan: a device f32 classifier value
# (or chroma norm) within this distance of a quantizer (or zeroing) threshold
# is flagged and its subfingerprint recomputed with the host oracle. The
# margin must bound the TRUE device-vs-oracle value error; tools/hw_parity.py
# and chip_smoke.py gate at measured < eps/2, so margin erosion is loud.
# Measured on an NVIDIA H100 80GB HBM3 (400 W limit) with every matmul at
# Precision.HIGHEST: max classifier-value error 6.2e-7 (pre-decoded path) and
# 4.8e-7 (fused ingest), small chroma-norm error 7.2e-8 and 5.0e-8 — about
# 16x below 1e-5. The flag rate is content-dependent and ~linear in the
# margin (0.09% of the synthetic bench season's hashes at 1e-5 on that
# card), and every flagged hash costs host-oracle rescan time, so the margin
# is a direct rescan-cost dial. NEEDLE_TPU_EXACT=0 disables flagging+rescan;
# NEEDLE_TPU_EXACT_EPS overrides the margin.
def _exact_eps() -> float:
    v = _os.environ.get("NEEDLE_TPU_EXACT_EPS")
    if v is not None:
        return float(v)
    return 1e-5


def _exact_enabled() -> bool:
    return _os.environ.get("NEEDLE_TPU_EXACT", "1") not in ("0", "")


def _post_chroma(chroma, W_cls, thresholds, n_frames, with_flags=False,
                 with_values=False):
    """Chroma filter -> normalize -> classifiers -> gray-coded u32 packing.

    With with_flags=True also returns a per-subfingerprint bool marking
    hashes whose quantization is within float noise of a threshold (rescan
    candidates for the bit-exact host pass). With with_values=True returns
    (values (n_sub, 16), chroma norms (n_filt,)) INSTEAD of hashes — the
    pre-quantization intermediates, for the on-device EXACT_EPS margin
    validation (tools/hw_parity.py)."""
    n_filt = n_frames - (len(CHROMA_FILTER_COEFFS) - 1)
    filtered = jnp.zeros((n_filt, NUM_BANDS), jnp.float32)
    for k_i, coeff in enumerate(CHROMA_FILTER_COEFFS):
        filtered = filtered + jnp.float32(coeff) * chroma[k_i : k_i + n_filt]
    norm = jnp.sqrt(jnp.sum(filtered * filtered, axis=1, keepdims=True))
    normalized = jnp.where(
        norm < CHROMA_NORM_THRESHOLD, 0.0, filtered / jnp.where(norm == 0, 1.0, norm)
    )
    n_sub = n_filt - (MAX_FILTER_WIDTH - 1)
    windows = jnp.concatenate(
        [normalized[k : k + n_sub] for k in range(MAX_FILTER_WIDTH)], axis=1
    )
    ab = jnp.dot(windows, W_cls, precision=_PREC)
    a, b = ab[:, 0::2], ab[:, 1::2]
    # SubtractLog via _accurate_log32 (see its docstring)
    values = _accurate_log32((1.0 + a) / (1.0 + b))
    if with_values:
        return values, norm[:, 0]
    q = (
        (values >= thresholds[None, :, 0]).astype(jnp.uint32)
        + (values >= thresholds[None, :, 1]).astype(jnp.uint32)
        + (values >= thresholds[None, :, 2]).astype(jnp.uint32)
    )
    gray = jnp.array([0, 1, 3, 2], jnp.uint32)[q]
    hashes = _pack_bits(gray)
    if not with_flags:
        return hashes
    eps = jnp.float32(_exact_eps())
    # classifier-value margin: min over (16 classifiers x 3 thresholds)
    margin = jnp.min(
        jnp.abs(values[:, :, None] - thresholds[None, :, :]), axis=(1, 2)
    )
    flag_val = margin < eps
    # norm-zeroing margin: normalized frame j feeds subfingerprints
    # j-15..j, so OR the per-frame flag over each 16-frame window
    flag_norm = jnp.abs(norm[:, 0] - jnp.float32(CHROMA_NORM_THRESHOLD)) < eps
    flag_norm_w = flag_norm[:n_sub]
    for k in range(1, MAX_FILTER_WIDTH):
        flag_norm_w = flag_norm_w | flag_norm[k : k + n_sub]
    return hashes, flag_val | flag_norm_w


@functools.partial(jax.jit, static_argnames=("n_frames",))
def _values_single(mono_i16, wc, ws, fold, W_cls, thresholds, n_frames):
    return _fingerprint_core_inline(
        mono_i16.astype(jnp.float32), wc, ws, fold, W_cls, thresholds,
        n_frames, with_values=True,
    )


def classifier_values_jax(mono_i16: np.ndarray):
    """Validation entry point: the pre-quantization classifier value matrix
    (n_sub, 16) and per-frame chroma norms of one mono 11025 Hz segment,
    computed on the default JAX backend with the SAME program structure as
    the production pipeline. tools/hw_parity.py compares these against the
    float64 NumPy oracle on the device to validate the NEEDLE_TPU_EXACT_EPS
    borderline margin there, not only on the CPU."""
    mono = np.asarray(mono_i16, dtype=np.int16)
    nf = num_frames(len(mono))
    if nf <= 0:
        return np.zeros((0, 16), np.float32), np.zeros((0,), np.float32)
    tables = _device_tables()
    pad_len = (nf + _ROWS_PER_FRAME + 1) * HOP_SIZE
    buf = np.zeros(pad_len, np.int16)
    buf[: min(len(mono), pad_len)] = mono[:pad_len]
    values, norms = _values_single(buf, *tables, nf)
    return np.asarray(values), np.asarray(norms)


# ---------------------------------------------------------------------------
# On-device ingest: polyphase rational resampling as a matmul, fused
# with downmix + fingerprinting in one jitted program.
#
# The reference resamples on host via libswresample (analyzer.rs:180-187);
# on a host with few cores that path is the analyze bottleneck, so for raw-PCM
# ingest the JAX backend uploads the source-rate i16 samples and does
# everything else on device. A block of k*M input samples produces exactly
# k*L output samples (L/M = 11025/in_rate reduced); each output is a
# windowed-sinc interpolation of 2H+1 neighbors, so one (k*M + 2H, k*L)
# matrix turns resampling into a large static matmul over input blocks.
# ---------------------------------------------------------------------------

_RS_HALF_TAPS = 32  # half-width H of the windowed-sinc filter (input samples)


@functools.lru_cache(maxsize=8)
def _resample_plan(in_rate: int) -> Tuple[int, int, int, np.ndarray]:
    """Returns (L, M, k, matrix) with matrix shape (k*M + 2H, k*L)."""
    import math

    g = math.gcd(SAMPLE_RATE, in_rate)
    L, M = SAMPLE_RATE // g, in_rate // g
    k = max(1, -(-128 // L))  # k*L >= 128 keeps the matmul N-dim efficient
    H = _RS_HALF_TAPS
    fc = 0.5 * min(1.0, L / M) * 0.945  # normalized cutoff (input rate)
    n_rows, n_cols = k * M + 2 * H, k * L
    j = np.arange(n_rows, dtype=np.float64)[:, None]
    p = np.arange(n_cols, dtype=np.float64)[None, :]
    t = p * M / L  # exact output centers in input samples
    x = (j - H) - t
    taps = 2.0 * fc * np.sinc(2.0 * fc * x)
    taps *= np.kaiser(2 * 4096 + 1, 9.0)[
        np.clip((x / H * 4096 + 4096).round().astype(np.int64), 0, 2 * 4096)
    ]
    taps[np.abs(x) > H] = 0.0
    # unit DC gain per phase
    taps /= taps.sum(axis=0, keepdims=True)
    return L, M, k, taps.astype(np.float32)


_rs_device_cache: dict = {}


def _rs_device_matrix(in_rate: int):
    if in_rate not in _rs_device_cache:
        _rs_device_cache[in_rate] = jax.device_put(_resample_plan(in_rate)[3])
    return _rs_device_cache[in_rate]


def _ingest_dims(in_rate: int, n_frames: int) -> Tuple[int, int, int]:
    """(n_blocks, in_len, out_len) for a given frame bucket: enough resampled
    samples for n_frames frames, derived statically from the bucket."""
    L, M, k, _ = _resample_plan(in_rate)
    out_needed = (n_frames + _ROWS_PER_FRAME + 1) * HOP_SIZE
    n_blocks = -(-out_needed // (k * L))
    in_len = (n_blocks + 1) * (k * M)  # +1 block so every window has margin
    return n_blocks, in_len, out_needed


def _resample_inline(flat_f32, rs_mat, in_rate: int, n_frames: int):
    """(in_len,) f32 at in_rate -> (out_padded,) f32 at 11025 Hz."""
    L, M, k, _ = _resample_plan(in_rate)
    H = _RS_HALF_TAPS
    n_blocks, in_len, out_needed = _ingest_dims(in_rate, n_frames)
    kM, kL = k * M, k * L
    # Left-pad by H so the first outputs see their full filter support and
    # output sample i lands exactly at input time i*M/L.
    flat_f32 = jnp.concatenate([jnp.zeros((H,), jnp.float32), flat_f32])
    rows = flat_f32[: n_blocks * kM].reshape(n_blocks, kM)
    margin = flat_f32[kM : kM + n_blocks * kM].reshape(n_blocks, kM)[:, : 2 * H]
    windows = jnp.concatenate([rows, margin], axis=1)
    out = jnp.dot(windows, rs_mat, precision=_PREC).reshape(-1)
    return out[:out_needed]


def _device_decimate2_hb_i32(x_2d, odd_q, c0):
    """(frames, C) int32 -> (frames//2, C) int32: EXACT replica of the
    native ni_decimate2_hb semantics (zero-padded edges, Q14 taps,
    (acc+8192)>>14 arithmetic shift, clip to i16 range) in pure integer
    ops, so decimation placed on device produces bit-identical samples to
    decimation placed on host.

    Every tap offset has fixed parity (H odd, distances odd), so the
    stride-2 accesses are expressed as UNIT-stride slices of an
    even/odd-deinterleaved view, which XLA keeps as plain slices instead
    of gathers."""
    n, C = x_2d.shape
    n_odd = len(odd_q)
    H = 2 * n_odd - 1
    out_n = n // 2
    # pad so total length is even and every window fits: offsets span
    # [H - H, H + H] + 2*out_n
    pad_top = H + 1  # even (keeps every offset's parity fixed)
    pad_bot = H + 1 + ((pad_top + n + H + 1) % 2)  # make total length even
    xp = jnp.concatenate(
        [
            jnp.zeros((pad_top, C), jnp.int32),
            x_2d,
            jnp.zeros((pad_bot, C), jnp.int32),
        ]
    )
    # xp index o maps to (o // 2, o % 2) of the deinterleaved view
    de = xp.reshape(-1, 2, C)
    even = de[:, 0, :]  # xp[2t]
    odd = de[:, 1, :]  # xp[2t+1]

    def sl(offset):
        """x[2k + offset] for k in [0, out_n) as a unit-stride slice."""
        o = offset + pad_top
        half, par = o // 2, o % 2
        src = even if par == 0 else odd
        return jax.lax.dynamic_slice_in_dim(src, half, out_n, axis=0)

    acc = jnp.int32(c0) * sl(0)
    for m, q in enumerate(odd_q):
        d = 2 * m + 1
        acc = acc + jnp.int32(int(q)) * (sl(-d) + sl(d))
    y = (acc + jnp.int32(8192)) >> jnp.int32(14)
    return jnp.clip(y, -32768, 32767)


def _decimate_mode() -> str:
    """Where the canonical band-limited decimation runs.

    "device" (default): the integer half-band FIR runs inside the fused
    device program — the host does nothing but memcpy, at the cost of
    uploading source-rate bytes.
    "host" (NEEDLE_TPU_DECIMATE=host or 1): the SAME integer FIR runs on
    the host before upload — halves/quarters the uploaded bytes. Decimated
    samples are bit-identical to the
    device placement; only float-resample fusion differences downstream
    can flip the rare borderline hash bit.
    "off" (NEEDLE_TPU_DECIMATE=0): no decimation; resample directly from
    the source rate (a different—but equally deterministic—hash basis).
    """
    v = _os.environ.get("NEEDLE_TPU_DECIMATE", "auto")
    if v in ("host", "1"):
        return "host"
    if v in ("0", "off", ""):
        return "off"
    return "device"


@functools.partial(
    jax.jit,
    static_argnames=(
        "mid_rate", "channels", "n_frames", "dec_factor", "with_flags",
        "with_values",
    ),
)
def _ingest_fingerprint_batched(
    batch_raw_i16, nv_b, rs_mat, wc, ws, fold, W_cls, thresholds,
    mid_rate, channels, n_frames, dec_factor=1, with_flags=False,
    with_values=False,
):
    """Fused device pipeline: [decimate ->] downmix -> resample ->
    fingerprint, vmapped over a FIXED number of lanes (one compiled
    program per (rate, bucket)). nv_b carries each lane's valid RAW frame
    count so decimated tails are masked exactly like the host placement's
    zero padding (the FIR rings past a segment's true end otherwise).
    with_flags additionally returns per-subfingerprint borderline flags
    (rescan candidates against the canonical host oracle,
    ingest_oracle.py); with_values returns the pre-quantization classifier
    values + chroma norms instead (margin validation, tools/hw_parity.py)."""

    def one(raw, nv):
        # Zero every frame >= the lane's valid count FIRST: lanes may carry
        # real samples past their segment's true end (uploading an extended
        # memmap slice costs no host copy, where zero-padding costs a full
        # memcpy), and the canonical semantics are zeros beyond the window
        # (what chromaprint would have been fed).
        x = raw.reshape(-1, channels).astype(jnp.int32)
        x = jnp.where(
            jax.lax.broadcasted_iota(jnp.int32, x.shape, 0) < nv, x, 0
        )
        if dec_factor > 1:
            from .decimate import _HB_MAIN, _HB_RELAXED, _halfband_q14

            nv1 = nv
            if dec_factor == 4:
                x = _device_decimate2_hb_i32(x, *_halfband_q14(*_HB_RELAXED))
                nv1 = nv1 // 2
                x = jnp.where(
                    jnp.arange(x.shape[0], dtype=jnp.int32)[:, None] < nv1,
                    x, 0,
                )
            x = _device_decimate2_hb_i32(x, *_halfband_q14(*_HB_MAIN))
            nv1 = nv1 // 2
            x = jnp.where(
                jnp.arange(x.shape[0], dtype=jnp.int32)[:, None] < nv1, x, 0
            )
        if channels == 2:
            # exact chromaprint downmix semantics: (l + r) / 2 with C
            # truncation toward zero (matches the host oracle bit-for-bit)
            s = x[:, 0] + x[:, 1]
            mono = jnp.where(s < 0, -((-s) >> 1), s >> 1).astype(jnp.float32)
        else:
            mono = x[:, 0].astype(jnp.float32)
        if mid_rate != SAMPLE_RATE:
            mono = _resample_inline(mono, rs_mat, mid_rate, n_frames)
        pad_len = (n_frames + _ROWS_PER_FRAME + 1) * HOP_SIZE
        mono = jnp.concatenate(
            [mono, jnp.zeros((max(0, pad_len - mono.shape[0]),), jnp.float32)]
        )[:pad_len]
        return _fingerprint_core_inline(
            mono, wc, ws, fold, W_cls, thresholds, n_frames,
            with_flags=with_flags, with_values=with_values,
        )

    return jax.vmap(one)(batch_raw_i16, nv_b)


# Fixed lane count per dispatch: a single compiled program serves any
# library size (the tail chunk is zero-padded). 8 was tuned for the
# accelerator this code was first written for and is untuned on the H100.
LANES = 8


def resampled_length(n_in: int, in_rate: int, channels: int = 1) -> int:
    """Output sample count at 11025 Hz for n_in interleaved input samples."""
    L, M, _, _ = _resample_plan(in_rate)
    return (n_in // channels) * L // M


class IngestDispatcher:
    """Device-ingest dispatcher. add() queues segments per frame bucket
    (memmap views are fine — no bytes move yet); each LANES-wide chunk of
    a bucket is uploaded in one device_put and dispatched to the fused
    resample+fingerprint program the moment it fills, so host reads ride
    under transfers; finish() flushes partial chunks and collects every
    output with coalesced downloads. A fixed lane count keeps one compiled
    program per frame bucket, and a chunk bounds both the per-transfer
    fixed cost and the size of any one transfer."""

    def __init__(self, in_rate: int, channels: int = 1):
        self.in_rate = in_rate
        self.channels = channels
        # The canonical band-limited decimation to >= 8 kHz runs on DEVICE
        # (mode "device"); input that was already host-decimated arrives
        # here at mid_rate with factor 1. Only factors 2 and 4 have the
        # half-band device kernels; other factors resample directly.
        from .decimate import decimation_factor

        f = decimation_factor(in_rate) if _decimate_mode() == "device" else 1
        self.dec_factor = f if f in (2, 4) else 1
        self.mid_rate = in_rate // self.dec_factor
        self._rs_mat = _rs_device_matrix(self.mid_rate)
        self._tables = _device_tables()
        self._pending: dict = {}  # nf_bucket -> (refs, segments)
        # (refs, device_out); in exact mode each device row is the
        # [hashes | flags] concat (split on download by _collect_lanes)
        self._launched: list = []
        self._out_lens: dict = {}  # ref -> n_sub
        self._empty: dict = {}  # ref -> empty result
        self._zero_rows: dict = {}  # in_len -> device zero row (pad lanes)
        # Borderline flag-and-rescan against the canonical host oracle
        # (ingest_oracle.py) makes the fused path's hashes exactly the
        # oracle's on every backend; the rescan needs each lane's raw
        # segment again, so keep the (zero-copy memmap) references around.
        self._exact = _exact_enabled()
        self._rescan_info: dict = {}  # ref -> (segment, n_valid, nf_bucket)

    def add(self, ref, segment: np.ndarray, n_valid: int = None) -> None:
        """Queue one segment. `segment` may EXTEND past the true window
        (e.g. an oversized memmap slice of the source file — costs no host
        copy); `n_valid` is the window's true sample count (interleaved;
        default: len(segment)). Samples past n_valid are zeroed on device,
        so results are identical to a zero-padded upload."""
        segment = np.asarray(segment, dtype=np.int16)
        if n_valid is None:
            n_valid = len(segment)
        n_dec = (n_valid // self.channels) // self.dec_factor
        n_res = resampled_length(n_dec * self.channels, self.mid_rate,
                                 self.channels)
        n_sub = num_subfingerprints(n_res)
        if n_sub <= 0:
            self._empty[ref] = np.zeros(0, np.uint32)
            return
        self._out_lens[ref] = n_sub
        nf_b = _bucket_frames(num_frames(n_res))
        if self._exact:
            self._rescan_info[ref] = (segment, n_valid, nf_b)
        refs, segs = self._pending.setdefault(nf_b, ([], []))
        refs.append(ref)
        segs.append((segment, n_valid))
        if len(refs) >= LANES:
            self._dispatch(nf_b)

    def _dispatch(self, nf_b: int) -> None:
        from ..tracing import span

        refs, segs = self._pending.pop(nf_b)
        _, in_len, _ = _ingest_dims(self.mid_rate, nf_b)
        in_len *= self.channels * self.dec_factor
        with span("ingest.batch_assemble"):
            # Lanes whose (extended) segment covers in_len upload the
            # memmap view DIRECTLY — the transfer engine streams from the
            # page cache and the host never memcpys the audio. Short lanes
            # fall back to a zero-padded copy.
            rows = []
            nv = np.zeros((LANES,), np.int32)
            for r in range(LANES):
                if r < len(segs):
                    s, n_valid = segs[r]
                    nv[r] = min(n_valid, in_len) // self.channels
                    if len(s) >= in_len:
                        rows.append(s[:in_len])
                        continue
                    buf = np.zeros(in_len, np.int16)
                    buf[: len(s)] = s
                    rows.append(buf)
                else:
                    # pad lanes reuse one cached device row: no bytes move
                    if in_len not in self._zero_rows:
                        self._zero_rows[in_len] = jax.device_put(
                            np.zeros(in_len, np.int16)
                        )
                    rows.append(self._zero_rows[in_len])
        with span("ingest.upload"):
            dev_rows = jax.device_put(rows)
        # Record the bytes that actually crossed the wire (numpy rows only
        # — cached device zero-rows move nothing) so the bench artifact can
        # verify value ≈ bytes/h2d + compute from its own fields.
        from ..tracing import metrics

        metrics.record(
            "ingest.upload_bytes",
            float(sum(r.nbytes for r in rows if isinstance(r, np.ndarray))),
        )
        with span("ingest.dispatch"):
            device_batch = jnp.stack(dev_rows)
            out = _ingest_fingerprint_batched(
                device_batch, jnp.asarray(nv), self._rs_mat, *self._tables,
                self.mid_rate, self.channels, nf_b, self.dec_factor,
                with_flags=self._exact,
            )
        if self._exact:
            # Ride the flags on the SAME download as the hashes: one
            # [hashes | flags] row per lane (device-side concat, no host
            # sync) instead of a second _collect_lanes pass and its round
            # trip. The flag bytes are trivial (~n_sub u32s/lane).
            self._launched.append(
                (refs, jnp.concatenate(
                    [out[0], out[1].astype(jnp.uint32)], axis=1))
            )
        else:
            self._launched.append((refs, out))

    def finish(self) -> dict:
        """Flush partial chunks, collect everything. Returns ref->hashes."""
        from ..tracing import span

        for nf_b in list(self._pending):
            self._dispatch(nf_b)
        flat_refs: List = []
        lane_lists = []
        for refs, out in self._launched:
            lane_ids = list(range(len(flat_refs), len(flat_refs) + len(refs)))
            flat_refs.extend(refs)
            lane_lists.append((lane_ids, out))
        out_lens = [self._out_lens[r] for r in flat_refs]
        from ..tracing import metrics

        metrics.record("ingest.hashes", float(sum(out_lens)))
        flat_results: List = [None] * len(flat_refs)
        if lane_lists:
            with span("ingest.collect"):
                _collect_lanes(
                    lane_lists, out_lens, flat_results, paired=self._exact
                )
        if self._exact and lane_lists:
            flat_flags = [
                t[1] if t is not None else None for t in flat_results
            ]
            flat_results = [
                t[0] if t is not None else None for t in flat_results
            ]
            self._rescan(flat_refs, flat_results, flat_flags)
        results = dict(self._empty)
        results.update(zip(flat_refs, flat_results))
        self._launched, self._pending, self._empty = [], {}, {}
        self._rescan_info = {}
        return results

    def _rescan(self, flat_refs, flat_results, flat_flags) -> None:
        """Recompute borderline-flagged subfingerprints with the canonical
        host oracle (ingest_oracle.ingest_hashes_window_oracle), making the
        returned hashes exactly the canonical basis's on every backend."""
        from ..tracing import span
        from .ingest_oracle import ingest_hashes_ranges_oracle
        from .numpy_impl import merge_flag_ranges

        from ..tracing import metrics

        total = sum(
            int(f.sum()) for f in flat_flags if f is not None and len(f)
        )
        metrics.record("ingest.rescan_flagged", float(total))
        if not total:
            return
        with span("ingest.rescan", flagged=total):
            for i, ref in enumerate(flat_refs):
                f = flat_flags[i]
                if f is None or not len(f) or not f.any():
                    continue
                segment, n_valid, nf_b = self._rescan_info[ref]
                ranges = merge_flag_ranges(np.nonzero(f)[0])
                outs = ingest_hashes_ranges_oracle(
                    segment, n_valid, self.in_rate, self.channels,
                    self.dec_factor, nf_b, ranges,
                )
                for (lo, hi), o in zip(ranges, outs):
                    flat_results[i][lo:hi] = o


def fingerprint_ingest_jax_batch(
    segments: Sequence[np.ndarray], in_rate: int, channels: int = 1,
    n_valids: Sequence[int] = None,
) -> List[np.ndarray]:
    """Fingerprint raw-PCM segments (i16 at in_rate, interleaved if stereo)
    entirely on device: [decimate ->] downmix -> resample -> hash in one
    fused program, dispatched in fixed-size lane chunks grouped by length
    bucket. Segments may extend past their true window when `n_valids`
    gives the true sample counts (see IngestDispatcher.add).

    Exactness: with NEEDLE_TPU_EXACT (default on), borderline-quantized
    hashes are flagged on device and recomputed with the canonical host
    oracle (ingest_oracle.py: bit-identical integer decimate/downmix, the
    device's own resample program structure evaluated in float64) — the
    returned hashes are exactly the canonical basis's on every backend.
    This basis differs from the reference's (host libswresample) only by
    the resampler; both are internally consistent, which is what the
    search needs. The pre-decoded 11025 Hz mono path (fingerprint_jax_batch)
    is additionally bit-exact against live libchromaprint."""
    if not segments:
        return []
    d = IngestDispatcher(in_rate, channels)
    for idx, s in enumerate(segments):
        d.add(idx, s, None if n_valids is None else n_valids[idx])
    results = d.finish()
    return [results[i] for i in range(len(segments))]


def ingest_classifier_values_jax(
    segment_i16: np.ndarray, in_rate: int, channels: int = 1,
    n_valid: int = None,
):
    """Pre-quantization classifier values + chroma norms of ONE fused-ingest
    lane, computed with the production program structure on the default JAX
    backend. tools/hw_parity.py compares these against
    ingest_oracle.ingest_values_oracle on the device to validate that the
    NEEDLE_TPU_EXACT_EPS margin also bounds the fused path's device-vs-
    canonical error (which includes the resample matmul approximation)."""
    segment = np.asarray(segment_i16, dtype=np.int16)
    if n_valid is None:
        n_valid = len(segment)
    d = IngestDispatcher(in_rate, channels)
    n_dec = (n_valid // channels) // d.dec_factor
    n_res = resampled_length(n_dec * channels, d.mid_rate, channels)
    nf_b = _bucket_frames(num_frames(n_res))
    _, in_len, _ = _ingest_dims(d.mid_rate, nf_b)
    in_len *= channels * d.dec_factor
    buf = np.zeros(in_len, np.int16)
    buf[: min(len(segment), in_len)] = segment[:in_len]
    nv = np.asarray([min(n_valid, in_len) // channels], np.int32)
    values, norms = _ingest_fingerprint_batched(
        jnp.asarray(buf[None, :]), jnp.asarray(nv), d._rs_mat, *d._tables,
        d.mid_rate, channels, nf_b, d.dec_factor, with_values=True,
    )
    n_sub = num_subfingerprints(n_res)
    return (
        np.asarray(values[0])[:n_sub],
        np.asarray(norms[0]),
        d.dec_factor,
        nf_b,
    )


def _collect_lanes(launched, out_lens, results, paired: bool = False) -> None:
    """Download chunk outputs with one transfer per output width, so each
    round trip's fixed cost is paid once per width instead of per chunk.

    With paired=True each device row is two equal halves concatenated on
    device ([hashes | rescan flags]); results get (hashes, flags) tuples —
    still one transfer per width."""
    by_width: dict = {}
    for lane_idxs, out in launched:
        by_width.setdefault(out.shape[1], []).append((lane_idxs, out))
    for width, items in by_width.items():
        if len(items) > 1:
            host_all = np.asarray(jnp.concatenate([o for _, o in items]))
        else:
            host_all = np.asarray(items[0][1])
        half = width // 2
        row0 = 0
        for lane_idxs, out in items:
            for r, si in enumerate(lane_idxs):
                row = host_all[row0 + r]
                n = out_lens[si]
                if paired:
                    results[si] = (
                        row[:n].astype(np.uint32),
                        row[half : half + n].astype(bool),
                    )
                else:
                    results[si] = row[:n].astype(np.uint32)
            row0 += out.shape[0]


from .._shapes import size_bucket as _bucket_frames  # noqa: E402  (shape buckets)


def downmix_stereo_i16_jnp(interleaved: jnp.ndarray) -> jnp.ndarray:
    """Stereo -> mono with C truncation-toward-zero semantics, on device."""
    x = interleaved.reshape(-1, 2).astype(jnp.int32)
    s = x[:, 0] + x[:, 1]
    return jnp.where(s < 0, -((-s) >> 1), s >> 1).astype(jnp.float32)


def fingerprint_jax(mono_i16: np.ndarray) -> np.ndarray:
    """mono i16 @ 11025 Hz -> u32 subfingerprints, computed on the JAX
    default backend."""
    return fingerprint_jax_batch([mono_i16])[0]


def fingerprint_jax_stereo(interleaved_i16: np.ndarray) -> np.ndarray:
    """Stereo interleaved i16 @ 11025 Hz -> subfingerprints (downmix on
    host to preserve exact C semantics, cheap)."""
    from .numpy_impl import downmix_stereo_i16

    return fingerprint_jax(downmix_stereo_i16(interleaved_i16))


def fingerprint_jax_batch(monos: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Fingerprint a batch of mono i16 episodes (11025 Hz).

    Episodes are grouped by frame bucket and dispatched in FIXED-size lane
    chunks (padding the tail), uploaded as int16 — one compiled program per
    bucket serves any library size, and the episodes axis is the natural
    data-parallel axis on TPU (sharding over meshes via needle_tpu.parallel).

    Bit-exactness: the device pipeline also flags hashes whose quantization
    landed within float noise of a classifier/zeroing threshold; flagged
    positions are recomputed with the host oracle (numpy_impl), making the
    returned hashes exactly equal to fingerprint_numpy's. Disable with
    NEEDLE_TPU_EXACT=0 (the search threshold absorbs the ~0.05% 1-bit
    differences; rescan costs a little host FFT time).
    """
    monos = [np.asarray(m, dtype=np.int16) for m in monos]
    if not monos:
        return []
    n_subs = [num_subfingerprints(len(m)) for m in monos]
    results: List[np.ndarray] = [None] * len(monos)  # type: ignore

    groups: dict = {}
    for idx, m in enumerate(monos):
        if n_subs[idx] <= 0:
            results[idx] = np.zeros(0, np.uint32)
            continue
        groups.setdefault(_bucket_frames(num_frames(len(m))), []).append(idx)

    from ..parallel import get_mesh, shard_batch

    mesh = get_mesh()
    lanes = LANES
    if mesh is not None:
        n_dev = int(np.prod(mesh.devices.shape))
        lanes = max(lanes, n_dev * max(1, lanes // n_dev))

    exact = _exact_enabled()
    tables = _device_tables()
    launched = []
    for nf_b, idxs in sorted(groups.items()):
        pad_len = (nf_b + _ROWS_PER_FRAME + 1) * HOP_SIZE
        for c0 in range(0, len(idxs), lanes):
            lane_idxs = idxs[c0 : c0 + lanes]
            batch = np.zeros((lanes, pad_len), np.int16)
            for r, si in enumerate(lane_idxs):
                m = monos[si]
                batch[r, : min(len(m), pad_len)] = m[:pad_len]
            device_batch, _ = shard_batch(batch)
            out = _fingerprint_core_batched(
                device_batch, *tables, nf_b, with_flags=exact
            )
            if exact:
                # one [hashes | flags] row per lane: flags ride the same
                # download as the hashes (see IngestDispatcher._dispatch)
                launched.append(
                    (lane_idxs, jnp.concatenate(
                        [out[0], out[1].astype(jnp.uint32)], axis=1))
                )
            else:
                launched.append((lane_idxs, out))

    _collect_lanes(launched, n_subs, results, paired=exact)
    if exact:
        # empty episodes were assigned plain arrays before collect — only
        # collected lanes hold (hashes, flags) tuples
        flags = [t[1] if isinstance(t, tuple) else None for t in results]
        results = [t[0] if isinstance(t, tuple) else t for t in results]
        _rescan_borderline(monos, results, flags)
    return results


def _rescan_borderline(monos, results, flags) -> None:
    """Recompute flagged (borderline-quantized) subfingerprints with the
    host oracle, in place. Flagged runs are merged into ranges so the
    ~19-frame dependency overhead is shared."""
    from .numpy_impl import fingerprint_numpy_window, merge_flag_ranges
    from ..tracing import span

    total = sum(int(f.sum()) for f in flags if f is not None and len(f))
    if not total:
        return
    with span("fingerprint.rescan", flagged=total):
        for idx, f in enumerate(flags):
            if f is None or not len(f) or not f.any():
                continue
            for lo, hi in merge_flag_ranges(np.nonzero(f)[0]):
                results[idx][lo:hi] = fingerprint_numpy_window(
                    monos[idx], lo, hi
                )
