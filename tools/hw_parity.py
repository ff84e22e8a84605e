#!/usr/bin/env python3
"""On-device exactness harness for the search kernels and the
fingerprint borderline margin.

Interpret-mode kernel tests run on the CPU; this harness runs the FULL
JaxSearchEngine with each kernel formulation — triton (the GPU default),
tiles, mxu — on the DEFAULT JAX backend over randomized + adversarial
hash libraries, and compares every `OpeningAndEndingInfo`'s complete
RunEntry lists (scores, run intervals, simhashes, flags, heap backing
order) against the reference-exact NumPy oracle. Libraries deliberately
cross the D_TILE=512 row-block boundary and stress the degenerate cases
from tests/test_engine_property.py (identical episodes, constant hashes
with multiple runs per diagonal, tiny sequences, near-threshold bit
flips).

It also validates the NEEDLE_TPU_EXACT_EPS borderline-rescan margin on
the device: max |values_device - values_oracle| and
|norm_device - norm_oracle| over synthetic audio, asserting the measured
error sits below half of the flagging margin (fingerprint/jax_impl.
_exact_eps) — plus an end-to-end hash bit-exactness check on music and
white noise.

Prints ONE JSON line.

Usage:
    python3 tools/hw_parity.py            # default backend (the GPU)
    JAX_PLATFORMS=cpu python3 tools/hw_parity.py --trials 2   # smoke
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

from needle_tpu.comparator import Comparator, NumpySearchEngine
from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration

KERNELS = ("triton", "tiles", "mxu")
# the Triton walk compiles for the GPU only; the CPU smoke run skips it
CPU_KERNELS = ("tiles", "mxu")


def _fh(h, ending=None, hash_ms=300):
    h = np.asarray(h, dtype=np.uint32)
    step = 247619033
    ts = (2600090703 + np.arange(len(h)) * step).astype(np.int64)
    if ending is None:
        eh, et = np.zeros(0, np.uint32), np.zeros(0, np.int64)
    else:
        eh = np.asarray(ending, dtype=np.uint32)
        et = (10**12 + np.arange(len(eh)) * step).astype(np.int64)
    return FrameHashes(h, ts, eh, et, Duration.from_millis(hash_ms), "f" * 32)


def make_libraries(rng, trials: int):
    """(name, [FrameHashes], threshold, min_opening_s, include_endings)."""
    libs = []
    for trial in range(trials):
        n_eps = int(rng.integers(2, 5))
        # cross the 512-diagonal-tile boundary in at least one episode
        lens = rng.integers(60, 900, size=n_eps)
        lens[int(rng.integers(0, n_eps))] = int(rng.integers(513, 1200))
        shared_len = int(rng.integers(20, 80))
        shared = rng.integers(0, 2**32, size=shared_len, dtype=np.uint32)
        fhs = []
        for e in range(n_eps):
            h = rng.integers(0, 2**32, size=int(lens[e]), dtype=np.uint32)
            if lens[e] > shared_len + 2:
                at = int(rng.integers(1, lens[e] - shared_len))
                h[at : at + shared_len] = shared
                flips = rng.integers(0, shared_len, size=4)
                h[at + flips] ^= np.uint32(1) << rng.integers(
                    0, 32, size=4
                ).astype(np.uint32)
            ending = None
            if trial % 2 == 0:
                ending = rng.integers(0, 2**32, size=int(lens[e] // 2),
                                      dtype=np.uint32)
                if lens[e] // 2 > shared_len:
                    ending[: shared_len] = shared
            fhs.append(_fh(h, ending))
        libs.append((
            f"random{trial}", fhs, int(rng.integers(0, 16)),
            int(rng.integers(2, 12)), trial % 2 == 0,
        ))
    # adversarial cases (test_engine_property degenerates, sized past the
    # tile boundary where relevant)
    h = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    libs.append(("identical", [_fh(h), _fh(h.copy())], 10, 5, False))
    c1 = np.zeros(600, np.uint32)
    c2 = np.zeros(600, np.uint32)
    c1[100] = 0xFFFFFFFF
    c2[480] = 0xFFFFFFFF
    libs.append(("constant-multi-run", [_fh(c1), _fh(c2)], 0, 3, False))
    libs.append(
        ("tiny", [_fh(np.zeros(1, np.uint32)), _fh(np.zeros(5, np.uint32))],
         5, 1, False)
    )
    return libs


def info_fields(info):
    """A fully-comparable representation of an OpeningAndEndingInfo."""
    def entries(lst):
        return [e.ord_key() for e in lst]

    return {
        "src_openings": entries(info.src_openings),
        "dst_openings": entries(info.dst_openings),
        "src_endings": entries(info.src_endings),
        "dst_endings": entries(info.dst_endings),
    }


def run_engine(fhs, threshold, min_open_s, include_endings, engine_name,
               kernel=None):
    from needle_tpu.search import jax_impl as S

    cmp = (
        Comparator.from_files(
            [f"v{k}.mkv" for k in range(len(fhs))], engine=engine_name
        )
        .with_hash_match_threshold(threshold)
        .with_min_opening_duration(Duration.from_secs(min_open_s))
        .with_min_ending_duration(Duration.from_secs(2))
        .with_include_endings(include_endings)
    )
    pairs = Comparator.pair_order(len(fhs))
    if kernel is not None:
        prev, S._KERNEL = S._KERNEL, kernel
        try:
            infos = cmp.search_pair_infos(fhs, pairs)
        finally:
            S._KERNEL = prev
    else:
        infos = cmp.search_pair_infos(fhs, pairs)
    return [info_fields(i) for i in infos]


def validate_exact_eps(rng, seconds: float = 120.0):
    """Max device-vs-oracle divergence of the pre-quantization classifier
    values / chroma norms, measured on the default backend."""
    from needle_tpu.fingerprint import numpy_impl as NP
    from needle_tpu.fingerprint.jax_impl import classifier_values_jax

    rate = 11025
    n = int(seconds * rate)
    # chromatically rich synthetic audio: summed glissandi + noise floor,
    # with an exponential fade-out so late frames have TINY chroma norms —
    # the regime where the 0.01 zeroing threshold (and hence the norm's
    # absolute error) actually matters.
    t = np.arange(n) / rate
    x = np.zeros(n)
    for k in range(12):
        f0, f1 = 80 * (k + 1), 120 * (k + 1)
        x += np.sin(2 * np.pi * (f0 * t + (f1 - f0) / (2 * t[-1]) * t * t + rng.uniform(0, 1)))
    x += 0.1 * rng.standard_normal(n)
    fade_from = int(0.7 * n)
    fade = np.ones(n)
    fade[fade_from:] = np.exp(-12.0 * (t[fade_from:] - t[fade_from]) / max(t[-1] - t[fade_from], 1e-9))
    x *= fade
    mono = np.clip(x / np.abs(x).max() * 20000, -32768, 32767).astype(np.int16)

    v_dev, n_dev = classifier_values_jax(mono)
    v_np, norm = NP.classifier_values_oracle(mono)

    n_sub = min(len(v_dev), len(v_np))
    max_val_err = float(np.max(np.abs(v_dev[:n_sub] - v_np[:n_sub])))
    n_frames = min(len(n_dev), len(norm))
    nd, nn = n_dev[:n_frames], norm[:n_frames]
    # The norm feeds only the `norm < 0.01` zeroing compare, so its
    # ABSOLUTE error matters only for small norms (loud frames have norms
    # ~1e6-1e10 where f32 ulp alone exceeds eps but can never cross 0.01);
    # validate absolute error on small-norm frames and relative overall.
    small = nn <= 1.0
    max_norm_err_small = (
        float(np.max(np.abs(nd[small] - nn[small]))) if small.any() else 0.0
    )
    max_norm_rel = float(np.max(np.abs(nd - nn) / np.maximum(nn, 1e-12)))
    return {
        "max_value_err": max_val_err,
        "max_norm_err_small": max_norm_err_small,
        "small_norm_frames": int(small.sum()),
        "max_norm_rel_err": max_norm_rel,
        "subfingerprints": n_sub,
    }


def hash_bit_exactness(rng, seconds: float = 60.0):
    """End-to-end on-device check of the flag-and-rescan claim: device
    hashes (with the backend's default EXACT_EPS margin) must equal the
    host oracle's bit for bit — on music-like audio (low flag rate) AND
    white noise (values concentrate near thresholds; worst-case rescan)."""
    from needle_tpu.fingerprint.jax_impl import fingerprint_jax
    from needle_tpu.fingerprint.numpy_impl import fingerprint_numpy
    from needle_tpu.search.oracle import popcount_u32
    from needle_tpu.testing import _music_like

    rate = 11025
    n = int(seconds * rate)
    samples = {
        "music": _music_like(rng, n, rate),
        "noise": np.clip(
            rng.standard_normal(n) * 8000, -32768, 32767
        ).astype(np.int16),
    }
    res = {}
    for name, mono in samples.items():
        t0 = time.time()
        a = np.asarray(fingerprint_jax(mono))
        b = fingerprint_numpy(mono)
        d = popcount_u32(a ^ b)
        res[name] = {
            "hashes": int(len(a)),
            "hashes_differing": int((d > 0).sum()),
            "max_hamming": int(d.max()) if len(d) else 0,
            "wall_s": round(time.time() - t0, 2),
        }
    return res


def validate_ingest_eps(rng, seconds: float = 60.0):
    """Fused-ingest margin validation: max device-vs-canonical divergence
    of the pre-quantization classifier values / chroma norms for the
    DEVICE-INGEST basis (ingest_oracle.py), which adds the polyphase
    resample matmul to the error budget. Measured on the default backend
    over the decimate-4 stereo path (the headline bench path's shape)."""
    from needle_tpu.fingerprint.ingest_oracle import ingest_values_oracle
    from needle_tpu.fingerprint.jax_impl import ingest_classifier_values_jax
    from needle_tpu.testing import _music_like

    in_rate, channels = 44100, 2
    n = int(seconds * in_rate)
    mono = _music_like(rng, n, in_rate)
    fade_from = int(0.7 * n)
    fade = np.ones(n)
    fade[fade_from:] = np.exp(
        -12.0 * np.arange(n - fade_from) / max(n - fade_from, 1)
    )
    stereo = np.empty(2 * n)
    stereo[0::2] = mono * fade
    stereo[1::2] = np.roll(mono, 31) * fade
    seg = np.clip(
        stereo / np.abs(stereo).max() * 20000, -32768, 32767
    ).astype(np.int16)

    v_dev, n_dev, dec, nf_b = ingest_classifier_values_jax(
        seg, in_rate, channels
    )
    v_np, norm = ingest_values_oracle(
        seg, len(seg), in_rate, channels, dec, nf_b, len(v_dev)
    )
    n_sub = min(len(v_dev), len(v_np))
    max_val_err = float(np.max(np.abs(v_dev[:n_sub] - v_np[:n_sub])))
    n_frames = min(len(n_dev), len(norm))
    nd, nn = n_dev[:n_frames], norm[:n_frames]
    small = nn <= 1.0
    max_norm_err_small = (
        float(np.max(np.abs(nd[small] - nn[small]))) if small.any() else 0.0
    )
    return {
        "max_value_err": max_val_err,
        "max_norm_err_small": max_norm_err_small,
        "small_norm_frames": int(small.sum()),
        "subfingerprints": n_sub,
        "dec_factor": dec,
    }


def ingest_hash_exactness(rng, seconds: float = 45.0):
    """End-to-end fused-ingest flag-and-rescan check on the default
    backend: hashes from the device pipeline (with the backend's margin)
    must equal the canonical host oracle's bit for bit — music AND noise,
    over the stereo decimate-4 path."""
    from needle_tpu.fingerprint.ingest_oracle import ingest_hashes_full_oracle
    from needle_tpu.fingerprint.jax_impl import (
        IngestDispatcher,
        _bucket_frames,
        fingerprint_ingest_jax_batch,
        resampled_length,
    )
    from needle_tpu.fingerprint.numpy_impl import (
        num_frames,
        num_subfingerprints,
    )
    from needle_tpu.search.oracle import popcount_u32
    from needle_tpu.testing import _music_like

    in_rate, channels = 44100, 2
    n = int(seconds * in_rate)
    music = _music_like(rng, n, in_rate)
    segs = {
        "music": np.clip(
            np.repeat(music / np.abs(music).max() * 20000, 2), -32768, 32767
        ).astype(np.int16),
        "noise": np.clip(
            rng.standard_normal(2 * n) * 8000, -32768, 32767
        ).astype(np.int16),
    }
    res = {}
    for name, seg in segs.items():
        t0 = time.time()
        a = np.asarray(fingerprint_ingest_jax_batch([seg], in_rate, channels)[0])
        d = IngestDispatcher(in_rate, channels)
        n_dec = (len(seg) // channels) // d.dec_factor
        n_res = resampled_length(n_dec * channels, d.mid_rate, channels)
        b = ingest_hashes_full_oracle(
            seg, len(seg), in_rate, channels, d.dec_factor,
            _bucket_frames(num_frames(n_res)), num_subfingerprints(n_res),
        )
        dd = popcount_u32(a ^ b)
        res[name] = {
            "hashes": int(len(a)),
            "hashes_differing": int((dd > 0).sum()),
            "max_hamming": int(dd.max()) if len(dd) else 0,
            "wall_s": round(time.time() - t0, 2),
        }
    return res


def make_prefilter_libraries(rng):
    """Libraries whose l_min supports a W>=8 prefilter block (20 s min
    opening at 300 ms hashes -> l_min 81 -> W=32): a 2-show mixed library
    (cross-show pairs skippable), an unrelated-only library (every pair
    skippable), and the weakest-qualifying-run adversary — a run of
    exactly l_min cells, each at exactly the hamming threshold, whose
    blocked correlation meets the keep bound with zero slack."""
    libs = []
    shared_a = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    shared_b = rng.integers(0, 2**32, size=120, dtype=np.uint32)
    fhs = []
    for shared in (shared_a, shared_b):
        for e in range(3):
            h = rng.integers(0, 2**32, size=700, dtype=np.uint32)
            at = 30 + 40 * e
            h[at : at + 120] = shared
            flips = rng.integers(0, 120, size=5)
            h[at + flips] ^= np.uint32(1) << rng.integers(
                0, 32, size=5
            ).astype(np.uint32)
            fhs.append(_fh(h))
    libs.append(("pf-mixed", fhs, 10, 20, False))
    libs.append((
        "pf-unrelated",
        [_fh(rng.integers(0, 2**32, size=600, dtype=np.uint32))
         for _ in range(4)],
        10, 20, False,
    ))
    thr = 10
    run = rng.integers(0, 2**32, size=81, dtype=np.uint32)
    h1 = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    h2 = rng.integers(0, 2**32, size=640, dtype=np.uint32)
    h1[37 : 37 + 81] = run
    noisy = run.copy()
    for k in range(81):
        for b in rng.choice(32, size=thr, replace=False):
            noisy[k] ^= np.uint32(1) << np.uint32(b)
    h2[160 : 160 + 81] = noisy
    libs.append(("pf-exact-threshold", [_fh(h1), _fh(h2)], thr, 20, False))
    return libs


def prefilter_parity(rng):
    """Forced-prefilter leg on the default backend. The prefilter's skip
    bound is computed as bf16 +/-1 matmuls claimed integer-exact
    (prefilter.py) — a device property interpret-mode tests can't
    back. Run the full JAX engine with NEEDLE_TPU_SEARCH_PREFILTER=on
    and compare every info against the oracle; report pairs skipped."""
    import os

    from needle_tpu.tracing import metrics

    libs = make_prefilter_libraries(rng)
    mismatches = []
    pairs = 0
    before = metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
    prev = os.environ.get("NEEDLE_TPU_SEARCH_PREFILTER")
    os.environ["NEEDLE_TPU_SEARCH_PREFILTER"] = "on"
    t0 = time.time()
    try:
        for name, fhs, thr, mo, endings in libs:
            want = run_engine(fhs, thr, mo, endings, "numpy")
            got = run_engine(fhs, thr, mo, endings, "jax")
            pairs += len(got)
            if got != want:
                bad = [k for k, (g, o) in enumerate(zip(got, want))
                       if g != o]
                mismatches.append({"library": name, "bad_pairs": bad[:8]})
    finally:
        if prev is None:
            os.environ.pop("NEEDLE_TPU_SEARCH_PREFILTER", None)
        else:
            os.environ["NEEDLE_TPU_SEARCH_PREFILTER"] = prev
    skipped = (
        metrics.snapshot().get("search.prefilter_skipped", (0.0,))[0]
        - before
    )
    out = {
        "exact": not mismatches,
        "libraries": len(libs),
        "pair_infos_checked": pairs,
        "pairs_skipped": int(skipped),
        "wall_s": round(time.time() - t0, 2),
    }
    if mismatches:
        out["mismatches"] = mismatches
    return out


def direct_parity(rng):
    """Forced direct-diagonal-flagging leg on the default backend: the
    flagged-diagonal superset claim (every qualifying run's aligned
    block pins its diagonal; prefilter._tile_diag_flags) rests on the
    same bf16 +/-1 integer-exactness as the prefilter bound, so it
    needs the same on-device backing. Runs the full JAX engine with
    NEEDLE_TPU_SEARCH_DIRECT=on over the prefilter adversary libraries
    (mixed, unrelated-only, weakest-qualifying zero-slack run) and
    compares every info against the oracle; reports flagged item count."""
    import os

    from needle_tpu.tracing import metrics

    libs = make_prefilter_libraries(rng)
    mismatches = []
    pairs = 0
    before = metrics.snapshot().get("search.direct_items", (0.0,))[0]
    prev = os.environ.get("NEEDLE_TPU_SEARCH_DIRECT")
    # plan gating reads the prefilter mode (small libraries need "on")
    prev_pf = os.environ.get("NEEDLE_TPU_SEARCH_PREFILTER")
    os.environ["NEEDLE_TPU_SEARCH_DIRECT"] = "on"
    os.environ["NEEDLE_TPU_SEARCH_PREFILTER"] = "on"
    t0 = time.time()
    try:
        for name, fhs, thr, mo, endings in libs:
            want = run_engine(fhs, thr, mo, endings, "numpy")
            got = run_engine(fhs, thr, mo, endings, "jax")
            pairs += len(got)
            if got != want:
                bad = [k for k, (g, o) in enumerate(zip(got, want))
                       if g != o]
                mismatches.append({"library": name, "bad_pairs": bad[:8]})
    finally:
        if prev is None:
            os.environ.pop("NEEDLE_TPU_SEARCH_DIRECT", None)
        else:
            os.environ["NEEDLE_TPU_SEARCH_DIRECT"] = prev
        if prev_pf is None:
            os.environ.pop("NEEDLE_TPU_SEARCH_PREFILTER", None)
        else:
            os.environ["NEEDLE_TPU_SEARCH_PREFILTER"] = prev_pf
    items = (
        metrics.snapshot().get("search.direct_items", (0.0,))[0] - before
    )
    out = {
        "exact": not mismatches,
        "libraries": len(libs),
        "pair_infos_checked": pairs,
        "direct_items": int(items),
        "wall_s": round(time.time() - t0, 2),
    }
    if mismatches:
        out["mismatches"] = mismatches
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--seed", type=int, default=20260817)
    ap.add_argument("--skip-eps", action="store_true")
    ap.add_argument("--eps-only", action="store_true")
    ap.add_argument("--eps-seconds", type=float, default=120.0)
    args = ap.parse_args()

    import jax

    backend = jax.default_backend()
    rng = np.random.default_rng(args.seed)
    libs = make_libraries(rng, args.trials)

    np.asarray(jax.device_put(np.ones(64, np.float32)) * 2.0)  # warm-up

    oracle = {}
    mismatches = []
    pairs_checked = 0
    kernel_times = {}
    all_kernels = KERNELS if backend == "gpu" else CPU_KERNELS
    kernels = () if args.eps_only else all_kernels
    for name, fhs, thr, mo, endings in (() if args.eps_only else libs):
        oracle[name] = run_engine(fhs, thr, mo, endings, "numpy")

    for kernel in kernels:
        t0 = time.time()
        for name, fhs, thr, mo, endings in libs:
            got = run_engine(fhs, thr, mo, endings, "jax", kernel=kernel)
            pairs_checked += len(got)
            if got != oracle[name]:
                bad = [
                    k for k, (g, o) in enumerate(zip(got, oracle[name]))
                    if g != o
                ]
                mismatches.append({"kernel": kernel, "library": name,
                                   "bad_pairs": bad[:8]})
        kernel_times[kernel] = round(time.time() - t0, 2)

    out = {
        "metric": "search kernel device parity (RunEntry-exact vs NumPy oracle)",
        "backend": backend,
        "exact": not mismatches,
        "kernels": list(kernels),
        "libraries": len(libs),
        "pair_infos_checked": pairs_checked,
        "kernel_times_s": kernel_times,
        "seed": args.seed,
    }
    if mismatches:
        out["mismatches"] = mismatches
    if not args.eps_only:
        # own rng stream: keeps the eps/hash legs' sample audio (and thus
        # their recorded error bounds) comparable across artifact records
        out["prefilter"] = prefilter_parity(
            np.random.default_rng(args.seed + 1)
        )
        out["direct"] = direct_parity(np.random.default_rng(args.seed + 1))
    if not args.skip_eps:
        eps_stats = validate_exact_eps(rng, seconds=args.eps_seconds)
        from needle_tpu.fingerprint.jax_impl import _exact_eps

        out["eps_margin"] = _exact_eps()
        out.update({f"eps_{k}": v for k, v in eps_stats.items()})
        out["eps_ok"] = (
            max(eps_stats["max_value_err"], eps_stats["max_norm_err_small"])
            < 0.5 * _exact_eps()
            and eps_stats["small_norm_frames"] > 0
        )
        hashes = hash_bit_exactness(rng)
        out["hash_parity"] = hashes
        out["hashes_bit_exact"] = all(
            v["hashes_differing"] == 0 for v in hashes.values()
        )
        ingest_eps = validate_ingest_eps(rng)
        out.update({f"ingest_eps_{k}": v for k, v in ingest_eps.items()})
        out["ingest_eps_ok"] = (
            max(
                ingest_eps["max_value_err"],
                ingest_eps["max_norm_err_small"],
            )
            < 0.5 * _exact_eps()
        )
        ingest_hashes = ingest_hash_exactness(rng)
        out["ingest_hash_parity"] = ingest_hashes
        out["ingest_hashes_bit_exact"] = all(
            v["hashes_differing"] == 0 for v in ingest_hashes.values()
        )
    print(json.dumps(out))
    pf = out.get("prefilter", {})
    dr = out.get("direct", {})
    return (
        0
        if out["exact"]
        and pf.get("exact", True)
        and pf.get("pairs_skipped", 1) > 0
        and dr.get("exact", True)
        and dr.get("direct_items", 1) > 0
        and out.get("eps_ok", True)
        and out.get("hashes_bit_exact", True)
        and out.get("ingest_eps_ok", True)
        and out.get("ingest_hashes_bit_exact", True)
        else 1
    )


if __name__ == "__main__":
    sys.exit(main())
