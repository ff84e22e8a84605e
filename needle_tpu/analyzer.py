"""Analyzer: per-video decode -> resample -> fingerprint -> FrameHashes.

Mirrors needle/src/audio/analyzer.rs. The decode/resample happens on host via
the native ingest layer (exact reference packet semantics); the fingerprint
math runs on the selected backend:

  * "jax"         — batched JAX/XLA pipeline on the default device (the
                    default, also selected by "auto"); episodes are
                    fingerprinted as one batch.
  * "numpy"       — the validated NumPy implementation (reference oracle).
  * "chromaprint" — ctypes to a system libchromaprint (bit-exact with that
                    exact build; optional).

Timestamp math replicates the reference exactly (analyzer.rs:286-318):
  delay = 28666 samples, item duration = 1365 samples (chromaprint TEST2),
  converted to Durations at full precision; ts_i = delay + item.mul_f32(i),
  stepping raw hash indices by hash_duration.as_millis()/item.as_millis();
  ending hashes additionally get seek_to added, where
  seek_to = stream_duration.mul_f32(1 - ending_search_percentage).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import constants
from .data import FrameHashes, frame_hash_data_path
from .duration import Duration
from .errors import AnalyzerMissingPaths
from .fingerprint.constants import DELAY_SAMPLES, ITEM_DURATION_SAMPLES, SAMPLE_RATE
from .util import compute_header_md5sum

# chromaprint-rust converts chromaprint's delay/item counters to Durations.
# Which conversion the crate (0.1.x) uses cannot be confirmed offline — its
# source is unavailable here and no cargo toolchain exists to produce a
# golden .needle.dat — so BOTH interpretations are implemented, switchable
# with NEEDLE_TPU_TS_MODE:
#
#   * "samples" (default): Duration from the sample counters at full f64
#     precision — delay = 28666/11025 s, item = 1365/11025 s. The C API
#     symbols are chromaprint_get_delay() / chromaprint_get_item_duration()
#     (chromaprint.h 1.5.x, "in samples"); converting needs the sample rate
#     (11025, chromaprint_get_sample_rate()) and gives the physically-exact
#     timestamp. The counters themselves (28666 / 1365) are verified against
#     the live libchromaprint 1.5.1 (tests/test_fingerprint.py).
#   * "ms": Duration::from_millis of the C API's millisecond accessors,
#     chromaprint_get_delay_ms() / chromaprint_get_item_duration_ms(),
#     which truncate (samples * 1000 / 11025 in integer math): delay =
#     2600 ms, item = 123 ms. If the crate wraps the _ms symbols, every
#     reference timestamp is quantized this way and drifts ~0.81 ms per
#     hash (~2 s by hash 2500) relative to "samples" mode.
#
# Both encodings are byte-golden-tested (tests/test_data.py); the decision
# trail and how to flip the default if a reference-produced golden file
# ever disagrees live in STATUS.md. step_by (analyzer.rs:293-296) divides
# truncated as_millis() values and is IDENTICAL in both modes (123 ms).
# NOTE: `.needle.dat` caches are keyed by header MD5 only (reference
# semantics), so files written under one mode are NOT invalidated by
# switching modes — re-analyze with force=True / --force after changing
# NEEDLE_TPU_TS_MODE.
_TS_MODES = ("samples", "ms")


def _ts_mode() -> str:
    import os

    v = os.environ.get("NEEDLE_TPU_TS_MODE", "samples")
    if v not in _TS_MODES:
        raise ValueError(
            f"NEEDLE_TPU_TS_MODE must be one of {_TS_MODES}, got {v!r}"
        )
    return v


def chromaprint_delay_item() -> Tuple[Duration, Duration]:
    """(hash delay, item duration) under the active NEEDLE_TPU_TS_MODE."""
    if _ts_mode() == "ms":
        return (
            Duration.from_millis(DELAY_SAMPLES * 1000 // SAMPLE_RATE),
            Duration.from_millis(ITEM_DURATION_SAMPLES * 1000 // SAMPLE_RATE),
        )
    return CHROMAPRINT_DELAY, CHROMAPRINT_ITEM_DURATION


# Module-level constants give the default ("samples") values; timestamp
# assembly goes through chromaprint_delay_item() so the mode is switchable.
CHROMAPRINT_DELAY = Duration.from_secs_f64(DELAY_SAMPLES / SAMPLE_RATE)
CHROMAPRINT_ITEM_DURATION = Duration.from_secs_f64(ITEM_DURATION_SAMPLES / SAMPLE_RATE)


def _fingerprint_backend(name: str):
    """Resolve a backend name to fn(stereo_interleaved_i16) -> uint32 array."""
    if name == "numpy":
        from .fingerprint.numpy_impl import fingerprint_numpy_stereo

        return fingerprint_numpy_stereo
    if name == "chromaprint":
        from .fingerprint.oracle import fingerprint_oracle

        return lambda pcm: fingerprint_oracle(pcm, channels=2)
    if name in ("jax", "auto"):
        # auto is the JAX engine; a failure to set it up raises
        from .fingerprint.jax_impl import fingerprint_jax_stereo

        return fingerprint_jax_stereo
    raise ValueError(f"unknown fingerprint backend: {name}")


class Analyzer:
    """Analyzes videos into FrameHashes (analyzer.rs:85-455)."""

    def __init__(self, videos: Sequence = (), backend: str = "auto"):
        self.videos: List[Path] = [Path(v) for v in videos]
        self.opening_search_percentage: float = (
            constants.DEFAULT_OPENING_SEARCH_PERCENTAGE
        )
        self.ending_search_percentage: float = (
            constants.DEFAULT_ENDING_SEARCH_PERCENTAGE
        )
        self.include_endings: bool = False
        self.threaded_decoding: bool = False
        self.force: bool = False
        self.backend_name = backend

    # -- builder API (analyzer.rs:108-151) ------------------------------------

    @classmethod
    def from_files(
        cls, videos: Sequence, threaded_decoding: bool = False, force: bool = False, **kw
    ) -> "Analyzer":
        a = cls(videos, **kw)
        a.threaded_decoding = threaded_decoding
        a.force = force
        return a

    def with_opening_search_percentage(self, v: float) -> "Analyzer":
        self.opening_search_percentage = float(v)
        return self

    def with_ending_search_percentage(self, v: float) -> "Analyzer":
        self.ending_search_percentage = float(v)
        return self

    def with_include_endings(self, v: bool) -> "Analyzer":
        self.include_endings = bool(v)
        return self

    def with_threaded_decoding(self, v: bool) -> "Analyzer":
        self.threaded_decoding = bool(v)
        return self

    def with_force(self, v: bool) -> "Analyzer":
        self.force = bool(v)
        return self

    # -- decode ---------------------------------------------------------------

    def _decode_segments(
        self, path: Path
    ) -> Tuple[np.ndarray, Optional[np.ndarray], Duration, Optional[Duration]]:
        """Decode the opening window and (optionally) the ending window.

        Returns (opening_pcm, ending_pcm, stream_duration, ending_seek_to),
        with PCM as S16 interleaved stereo @ 11025 Hz.
        """
        from . import ingest

        if ingest.is_pcm_file(path):
            pcm, duration_secs = ingest.load_pcm_as_chromaprint_input(path)
            stream_duration = Duration.from_secs_f64(duration_secs)
            opening_duration = stream_duration.mul_f32(
                np.float32(self.opening_search_percentage)
            )
            n_open = int(opening_duration.as_secs_f64() * SAMPLE_RATE) * 2
            opening_pcm = pcm[:n_open]
            ending_pcm, seek_to = None, None
            if self.include_endings:
                seek_to = stream_duration.mul_f32(
                    np.float32(1.0) - np.float32(self.ending_search_percentage)
                )
                # ms-truncated like the reference's seek (audio/util.rs:36-38)
                # and the device-ingest path
                n_skip = int((seek_to.as_millis() / 1000.0) * SAMPLE_RATE) * 2
                ending_pcm = pcm[n_skip:]
            return opening_pcm, ending_pcm, stream_duration, seek_to

        # First probe duration (cheap open), mirroring analyzer.rs:362-374.
        duration_secs = ingest.stream_duration_secs(path)
        return self._decode_segments_av(path, duration_secs)

    def _decode_segments_av(self, path: Path, duration_secs: float):
        from . import ingest

        stream_duration = Duration.from_secs_f64(duration_secs)

        opening_duration = stream_duration.mul_f32(
            np.float32(self.opening_search_percentage)
        )
        opening_pcm, _ = ingest.decode_audio(
            path,
            seek_to_secs=None,
            duration_limit_secs=opening_duration.as_secs_f64(),
            sample_rate=SAMPLE_RATE,
            threaded=self.threaded_decoding,
        )
        ending_pcm, seek_to = None, None
        if self.include_endings:
            seek_to = stream_duration.mul_f32(
                np.float32(1.0) - np.float32(self.ending_search_percentage)
            )
            # The reference seeks using ms-truncated timestamps
            # (audio/util.rs:36-38).
            ending_pcm, _ = ingest.decode_audio(
                path,
                seek_to_secs=seek_to.as_millis() / 1000.0,
                duration_limit_secs=None,
                sample_rate=SAMPLE_RATE,
                threaded=self.threaded_decoding,
            )
        return opening_pcm, ending_pcm, stream_duration, seek_to

    # -- device ingest (raw PCM -> device resample/downmix/fingerprint) --------

    def _use_device_ingest(self, path) -> bool:
        """Raw-PCM sources on the JAX backend skip host swr entirely: the
        source-rate samples are uploaded and resampled/downmixed/hashed in
        one fused device program (fingerprint.jax_impl.
        fingerprint_ingest_jax_batch)."""
        from . import ingest

        return self.backend_name in ("jax", "auto") and ingest.is_pcm_file(
            path
        )

    def _raw_segments(
        self, path: Path
    ) -> Tuple[np.ndarray, int, Optional[np.ndarray], Optional[int],
               int, int, Optional[Duration]]:
        """Source-rate opening/ending windows of a PCM file (no resample).

        Returns (opening_seg, opening_n_valid, ending_seg, ending_n_valid,
        rate, channels, seek_to) with the same window semantics as
        _decode_segments, sliced in source samples. Segments may EXTEND
        past their window's true end (n_valid samples): the opening is the
        whole memmap with n_valid = the window length, so the upload path
        can stream an oversized view straight from the page cache and the
        device zeroes the excess (IngestDispatcher.add).
        """
        from . import ingest
        from .tracing import span

        with span("ingest.read_raw"):
            samples, rate, channels, duration_secs = ingest.read_pcm_mmap(path)
        stream_duration = Duration.from_secs_f64(duration_secs)
        opening_duration = stream_duration.mul_f32(
            np.float32(self.opening_search_percentage)
        )
        n_open = int(opening_duration.as_secs_f64() * rate) * channels
        opening_seg, opening_nv = samples, n_open
        ending_seg, ending_nv, seek_to = None, None, None
        if self.include_endings:
            seek_to = stream_duration.mul_f32(
                np.float32(1.0) - np.float32(self.ending_search_percentage)
            )
            n_skip = int((seek_to.as_millis() / 1000.0) * rate) * channels
            ending_seg = samples[n_skip:]
            ending_nv = len(ending_seg)

        # Band-limited decimation to >= 8 kHz (chroma uses nothing above
        # ~3520 Hz) runs ON DEVICE by default — inside the fused ingest
        # program, via an integer half-band FIR bit-identical to the native
        # host kernel (fingerprint.jax_impl._decimate_mode) — so the 1-core
        # host does nothing here. NEEDLE_TPU_DECIMATE=host (or 1) moves the
        # SAME integer FIR to the native layer before upload, halving/
        # quartering the uploaded bytes for starved pipes.
        from .fingerprint.jax_impl import _decimate_mode

        if _decimate_mode() == "host":
            from .fingerprint.decimate import decimation_factor, host_decimate

            if decimation_factor(rate) > 1:
                with span("ingest.decimate"):
                    opening_seg, new_rate = host_decimate(
                        np.asarray(samples[:n_open]), rate, channels
                    )
                    opening_nv = len(opening_seg)
                    if ending_seg is not None:
                        ending_seg, _ = host_decimate(
                            np.asarray(ending_seg), rate, channels
                        )
                        ending_nv = len(ending_seg)
                    rate = new_rate
            if channels == 2:
                # The fused device program's order is decimate -> downmix
                # (fingerprint_ingest_jax_batch), so applying the SAME
                # integer downmix ((l+r)/2, C truncation) here — after the
                # host FIR — is bit-identical to the device placement and
                # halves the uploaded bytes again on starved pipes.
                from .fingerprint.numpy_impl import downmix_stereo_i16

                with span("ingest.downmix"):
                    # Trim to an even interleaved count first: a truncated
                    # stereo source can end mid-frame, and the device
                    # placement already drops the dangling sample via
                    # n_valid // channels — match it instead of letting
                    # reshape(-1, 2) raise.
                    opening_seg = downmix_stereo_i16(
                        np.asarray(opening_seg[: opening_nv & ~1])
                    )
                    opening_nv = len(opening_seg)
                    if ending_seg is not None:
                        ending_seg = downmix_stereo_i16(
                            np.asarray(ending_seg[: ending_nv & ~1])
                        )
                        ending_nv = len(ending_seg)
                    channels = 1
        return (opening_seg, opening_nv, ending_seg, ending_nv,
                rate, channels, seek_to)

    # -- hash assembly (analyzer.rs:286-318) -----------------------------------

    # Timestamp tables are identical across episodes (ts_i depends only on the
    # raw index i); cache them per (step_by, length).
    _ts_table_cache: dict = {}

    @classmethod
    def _ts_table(cls, step_by: int, count: int) -> np.ndarray:
        """int64 nanos of delay + item.mul_f32(i) for i = 0, step, 2*step..."""
        delay, item = chromaprint_delay_item()
        key = (step_by, _ts_mode())
        cached = cls._ts_table_cache.get(key)
        if cached is None or len(cached) < count:
            want = max(count, 2 * len(cached) if cached is not None else count, 1024)
            idx = np.arange(0, want * step_by, step_by, dtype=np.int64)
            item_f32 = item.as_secs_f32()
            prods = np.float32(idx.astype(np.float32) * item_f32)
            # Duration::from_secs_f32: exact f32 value -> nanos, half-even.
            # For values in this range the f32 is exactly representable in
            # f64, so float64(prod) * 1e9 rounded half-even equals the
            # Fraction-exact computation (f32 has 24-bit mantissa; the ns
            # product fits f64's 53 bits exactly for < ~9e6 seconds... use
            # exact Fraction math in one vectorized pass to be safe).
            from fractions import Fraction

            cached = np.array(
                [round(Fraction(float(p)) * 10**9) for p in prods], dtype=np.int64
            )
            cached += delay.total_nanos()
            cls._ts_table_cache[key] = cached
        return cached[:count]

    @staticmethod
    def _hashes_with_timestamps(
        raw_hashes: np.ndarray,
        hash_duration: Optional[Duration],
        seek_to: Optional[Duration],
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Select every step_by-th raw hash and attach reference-exact
        timestamps. Returns (uint32 hashes, int64 ts_nanos)."""
        if hash_duration is not None:
            item = chromaprint_delay_item()[1]
            step_by = hash_duration.as_millis() // item.as_millis()
            if step_by == 0:
                # Rust Iterator::step_by(0) panics.
                raise ValueError("hash_duration shorter than chromaprint item duration")
        else:
            step_by = 1
        idx = np.arange(0, len(raw_hashes), step_by, dtype=np.int64)
        hashes = np.asarray(raw_hashes, dtype=np.uint32)[idx]
        ts = Analyzer._ts_table(step_by, len(idx)).copy()
        if seek_to is not None:
            ts += seek_to.total_nanos()
        return hashes, ts

    # -- single video -----------------------------------------------------------

    def run_single(
        self, path, hash_duration: Duration, persist: bool
    ) -> FrameHashes:
        """analyzer.rs:326-420."""
        path = Path(path)
        fp = _fingerprint_backend(self.backend_name)
        frame_hash_path = frame_hash_data_path(path)

        md5 = compute_header_md5sum(path)
        if not self.force and frame_hash_path.exists():
            try:
                data = FrameHashes.from_path(frame_hash_path)
            except Exception:
                data = None
            if data is not None and data.md5() == md5:
                print(f"Skipping analysis for {path}...")
                return data

        if self._use_device_ingest(path):
            from .fingerprint.jax_impl import fingerprint_ingest_jax_batch

            (op_seg, op_nv, en_seg, en_nv, rate, channels, seek_to) = (
                self._raw_segments(path)
            )
            segs = [op_seg] + ([en_seg] if en_seg is not None else [])
            nvs = [op_nv] + ([en_nv] if en_seg is not None else [])
            outs = fingerprint_ingest_jax_batch(segs, rate, channels, nvs)
            opening_hashes = outs[0]
            ending_hashes = outs[1] if en_seg is not None else None
        else:
            opening_pcm, ending_pcm, _, seek_to = self._decode_segments(path)
            opening_hashes = fp(opening_pcm)
            ending_hashes = fp(ending_pcm) if ending_pcm is not None else None

        oh, ot = self._hashes_with_timestamps(opening_hashes, hash_duration, None)
        if ending_hashes is not None:
            eh, et = self._hashes_with_timestamps(
                ending_hashes, hash_duration, seek_to
            )
        else:
            eh = np.zeros(0, np.uint32)
            et = np.zeros(0, np.int64)

        frame_hashes = FrameHashes(oh, ot, eh, et, hash_duration, md5)
        if persist:
            frame_hashes.save(frame_hash_path)
        return frame_hashes

    # -- all videos --------------------------------------------------------------

    def run(
        self, hash_duration: Duration, persist: bool, threading: bool = True
    ) -> List[FrameHashes]:
        """analyzer.rs:425-455.

        Decode runs on host threads; with the JAX backend all episodes'
        segments are fingerprinted as ONE batched device dispatch (the
        episodes axis is the device replacement for the reference's rayon
        fan-out, and shards over meshes)."""
        if len(self.videos) == 0:
            raise AnalyzerMissingPaths()
        if isinstance(hash_duration, (int, float)):
            hash_duration = Duration.from_secs_f32(np.float32(hash_duration))

        if len(self.videos) > 1 and self.backend_name in ("jax", "auto"):
            return self._run_batched(hash_duration, persist, threading)

        if threading and len(self.videos) > 1:
            with ThreadPoolExecutor() as pool:
                return list(
                    pool.map(
                        lambda p: self.run_single(p, hash_duration, persist),
                        self.videos,
                    )
                )
        return [self.run_single(p, hash_duration, persist) for p in self.videos]

    # Episodes per streaming wave: bounds host PCM memory for 1000+ episode
    # libraries (each wave's decode overlaps the previous wave's async
    # device dispatches).
    STREAM_BLOCK = 64

    def _run_batched(
        self, hash_duration: Duration, persist: bool, threading: bool
    ) -> List[FrameHashes]:
        """Batched analyze in streaming waves of STREAM_BLOCK episodes."""
        videos = [Path(p) for p in self.videos]
        results: List[FrameHashes] = []
        for w0 in range(0, len(videos), self.STREAM_BLOCK):
            results.extend(
                self._run_batched_block(
                    videos[w0 : w0 + self.STREAM_BLOCK],
                    hash_duration,
                    persist,
                    threading,
                )
            )
        return results

    def _run_batched_block(
        self, videos: List[Path], hash_duration: Duration, persist: bool,
        threading: bool,
    ) -> List[FrameHashes]:
        """One wave: threaded read/decode -> chunked device dispatches ->
        assembly/persist. Cache semantics identical to run_single.

        Raw-PCM sources use the fused device-ingest pipeline (upload
        source-rate i16; resample/downmix/fingerprint on device); compressed
        media decodes on host then fingerprints on device.
        """
        from .data import FrameHashes as FH
        from .fingerprint.jax_impl import (
            fingerprint_ingest_jax_batch,
            fingerprint_jax_batch,
        )
        from .fingerprint.numpy_impl import downmix_stereo_i16
        from .tracing import span

        def prepare(path):
            md5 = compute_header_md5sum(path)
            fhp = frame_hash_data_path(path)
            if not self.force and fhp.exists():
                try:
                    data = FH.from_path(fhp)
                except Exception:
                    data = None
                if data is not None and data.md5() == md5:
                    print(f"Skipping analysis for {path}...")
                    return ("cached", data)
            if self._use_device_ingest(path):
                (op_seg, op_nv, en_seg, en_nv, rate, channels, seek_to) = (
                    self._raw_segments(path)
                )
                ending = (en_seg, en_nv) if en_seg is not None else None
                return ("raw", md5, (op_seg, op_nv), ending,
                        seek_to, rate, channels)
            opening_pcm, ending_pcm, _, seek_to = self._decode_segments(path)
            return (
                "decoded",
                md5,
                downmix_stereo_i16(opening_pcm),
                downmix_stereo_i16(ending_pcm) if ending_pcm is not None else None,
                seek_to,
            )

        # Stream: as each episode's read/decode completes, its segments are
        # fed to the device dispatchers immediately — full lane chunks
        # dispatch asynchronously, so host reads ride under the
        # host->device transfers instead of serializing before them.
        from .fingerprint.jax_impl import IngestDispatcher

        mono_segments: List[np.ndarray] = []
        mono_refs: List[tuple] = []  # (video_idx, "opening"/"ending")
        raw_dispatchers: dict = {}  # (rate, channels) -> IngestDispatcher
        prepped: List[tuple] = []

        def consume(vi: int, item: tuple) -> None:
            prepped.append(item)
            if item[0] == "cached":
                return
            if item[0] == "raw":
                _, _, (op_seg, op_nv), ending, _, rate, channels = item
                d = raw_dispatchers.get((rate, channels))
                if d is None:
                    d = raw_dispatchers[(rate, channels)] = IngestDispatcher(
                        rate, channels
                    )
                d.add((vi, "opening"), op_seg, op_nv)
                if ending is not None:
                    d.add((vi, "ending"), ending[0], ending[1])
            else:
                _, _, opening_mono, ending_mono, _ = item
                mono_segments.append(opening_mono)
                mono_refs.append((vi, "opening"))
                if ending_mono is not None:
                    mono_segments.append(ending_mono)
                    mono_refs.append((vi, "ending"))

        with span("analyze.decode", videos=len(videos)):
            if threading and len(videos) > 1:
                # Sized to the host: prepare() is CPU-bound (decode + FIR),
                # so workers beyond the core count only add context-switch
                # and cache-thrash overhead on small hosts.
                # Uploads still overlap: consume() dispatches async
                # device_puts on the main thread between pool yields.
                import os as _os

                workers = max(1, min(4, _os.cpu_count() or 4))
                with ThreadPoolExecutor(max_workers=workers) as pool:
                    for vi, item in enumerate(pool.map(prepare, videos)):
                        consume(vi, item)
            else:
                for vi, path in enumerate(videos):
                    consume(vi, prepare(path))

        hashes_by_ref = {}
        with span(
            "analyze.fingerprint",
            mono=len(mono_segments),
            raw=sum(len(d._out_lens) for d in raw_dispatchers.values()),
        ):
            if mono_segments:
                outs = fingerprint_jax_batch(mono_segments)
                hashes_by_ref.update(dict(zip(mono_refs, outs)))
            for d in raw_dispatchers.values():
                hashes_by_ref.update(d.finish())

        results: List[FrameHashes] = []
        with span("analyze.assemble"):
            for vi, (path, item) in enumerate(zip(videos, prepped)):
                if item[0] == "cached":
                    results.append(item[1])
                    continue
                md5, seek_to = item[1], item[4]
                has_ending = item[3] is not None
                oh, ot = self._hashes_with_timestamps(
                    hashes_by_ref[(vi, "opening")], hash_duration, None
                )
                if has_ending:
                    eh, et = self._hashes_with_timestamps(
                        hashes_by_ref[(vi, "ending")], hash_duration, seek_to
                    )
                else:
                    eh = np.zeros(0, np.uint32)
                    et = np.zeros(0, np.int64)
                fh = FrameHashes(oh, ot, eh, et, hash_duration, md5)
                if persist:
                    fh.save(frame_hash_data_path(path))
                results.append(fh)
        return results
