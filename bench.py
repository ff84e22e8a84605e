#!/usr/bin/env python3
"""End-to-end benchmark: analyze + search a 28-episode season on one chip.

Mirrors the reference's headline numbers (aksiksi/needle README.md:96-108):
analyze 28 x ~20 min episodes (11.983 s wall on a multi-core CPU via rayon)
then all-pairs search over the pre-computed hashes (378 pairs, 5.617 s wall).
Here both phases run through the JAX engines on the default device:
batched fingerprinting (episodes axis) and the batched diagonal-run
search (pairs axis).

Prints a detail JSON line and then a compact headline JSON line:
  {"metric": ..., "value": <total wall s>, "unit": "s",
   "vs_baseline": <value / 17.6 — ratio to the reference's total;
                   lower is better>, ...component timings/accuracy...}

The synthetic season (16 kHz mono WAV episodes sharing an opening and an
ending segment, ground truth known) is generated once and cached under
.bench_cache/.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# The bench season is WAV/PCM; discovery defaults to strict reference
# semantics (video stream required), so the bench opts in explicitly.
os.environ.setdefault("NEEDLE_TPU_ALLOW_AUDIO", "1")
sys.path.insert(0, str(REPO))

import numpy as np

BASELINE_ANALYZE_S = 11.983  # reference README.md:100-102
BASELINE_SEARCH_S = 5.617  # reference README.md:104-105
BASELINE_TOTAL_S = BASELINE_ANALYZE_S + BASELINE_SEARCH_S

NUM_EPISODES = 28
EPISODE_SECS = 1200.0
OPENING_SECS = 85.0
ENDING_SECS = 70.0
RATE = 16000
SEED = 20260816
TRIALS = int(os.environ.get("NEEDLE_BENCH_TRIALS", "5"))

CACHE = REPO / ".bench_cache" / (
    f"season{NUM_EPISODES}_{int(EPISODE_SECS)}s_r{RATE}_s{SEED}_v2"
)


def build_season():
    marker = CACHE / "TRUTH.json"
    if marker.exists():
        truth = json.loads(marker.read_text())
        paths = [CACHE / p for p in truth["paths"]]
        if all(p.exists() for p in paths):
            return paths, truth["opening"], truth["ending"]
    from needle_tpu.testing import make_synthetic_season

    CACHE.mkdir(parents=True, exist_ok=True)
    paths, op_truth, end_truth = make_synthetic_season(
        CACHE,
        num_episodes=NUM_EPISODES,
        episode_secs=EPISODE_SECS,
        opening_secs=OPENING_SECS,
        opening_offset_range=(5.0, 40.0),
        ending_secs=ENDING_SECS,
        rate=RATE,
        seed=SEED,
    )
    marker.write_text(
        json.dumps(
            {
                "paths": [p.name for p in paths],
                "opening": op_truth,
                "ending": end_truth,
            }
        )
    )
    return paths, op_truth, end_truth


# Stage names worth surfacing in the bench JSON (tracing spans recorded by
# the engines), so a slow trial is attributable from the output alone.
_STAGE_KEYS = (
    "ingest.read_raw",
    "ingest.decimate",
    "ingest.batch_assemble",
    "ingest.upload",
    "ingest.dispatch",
    "ingest.collect",
    "ingest.rescan",
    "analyze.decode",
    "analyze.fingerprint",
    "analyze.assemble",
    "fingerprint.rescan",
    "search.pairs",
    "search.prefilter",
    "search.launch",
    "search.collect",
    "search.collect_device",
    "search.collect_unpack",
    "search.extract",
    "search.entries",
)

# Workload diagnostics that are COUNTS, not seconds — reported in a
# separate counts_per_trial field so the _s table stays homogeneous.
_COUNT_KEYS = (
    "search.extract_diags",
    "search.extract_host_fallback",
    "search.prefilter_skipped",
    "search.direct_items",
    "ingest.upload_bytes",
)

# Fields that belong on the FINAL compact headline line. Everything else
# (per-trial stage dicts) goes on a separate detail line printed BEFORE
# it, so stage dicts can never push the headline fields out of a
# tail-of-output capture.
_HEADLINE_KEYS = (
    "metric",
    "value",
    "unit",
    "vs_baseline",
    "speedup_vs_reference",
    "value_total_min",
    "analyze_s",
    "search_s",
    "accuracy_vs_truth",
    "bytes_uploaded_mb",
    "decode_s",
    "minutes_audio_per_sec_analyze",
    "pairs_per_sec_search",
    "pairs_per_sec",
    "episodes_matched",
    "trials",
    "trials_run",
    "partial",
    "error",
)
HEADLINE_BUDGET_B = 1024


def emit_result(base, flush=False):
    """Print a bench result as TWO JSON lines: a detail line first (stage
    breakdowns, probes, per-trial lists — unbounded size), then a compact
    headline guaranteed <= HEADLINE_BUDGET_B bytes so the driver's tail
    capture always parses it. The headline is always the LAST line."""
    headline = {k: base[k] for k in _HEADLINE_KEYS if k in base}
    detail = {k: v for k, v in base.items() if k not in headline}
    if detail:
        print(
            json.dumps({"detail_for": base.get("metric"), **detail}),
            flush=flush,
        )
    err = headline.get("error")
    if err is not None and len(str(err)) > 300:
        headline["error"] = str(err)[:297] + "..."
    line = json.dumps(headline)
    if len(line) > HEADLINE_BUDGET_B:
        # Drop mid-value metrics first until it fits. The driver fields
        # AND the diagnostic flags ("partial", "error") are never dropped,
        # so a failed run stays distinguishable from a clean result.
        keep = ("metric", "value", "unit", "vs_baseline", "partial", "error")
        for k in reversed(list(headline)):
            if k in keep:
                continue
            headline.pop(k)
            line = json.dumps(headline)
            if len(line) <= HEADLINE_BUDGET_B:
                break
    print(line, flush=True)


def _stage_snapshot():
    from needle_tpu.tracing import metrics

    return {k: v[0] for k, v in metrics.snapshot().items()}


def _stage_delta(before, after):
    """Per-stage wall seconds accumulated between two snapshots, plus
    workload counts under a nested "counts" key."""
    out = {}
    for k in _STAGE_KEYS:
        d = after.get(k, 0.0) - before.get(k, 0.0)
        if d > 1e-4:
            out[k] = round(d, 3)
    counts = {}
    for k in _COUNT_KEYS:
        d = after.get(k, 0.0) - before.get(k, 0.0)
        if d > 0:
            counts[k] = int(d)
    if counts:
        out["counts"] = counts
    return out


def warm_device():
    """One small device round trip before timing, so device start-up is
    not charged to the first trial."""
    import jax

    np.asarray(jax.device_put(np.ones(64, np.float32)) * 2.0)


def run_analyze(paths, hash_duration):
    from needle_tpu import Analyzer

    return (
        Analyzer.from_files(paths, force=True, backend="jax")
        .with_include_endings(True)
        .run(hash_duration, persist=True)
    )


def run_search(paths):
    from needle_tpu import Comparator

    cmp = Comparator.from_files(paths, engine="jax").with_include_endings(True)
    return cmp.run(
        analyze=False, display=False, use_skip_files=False, write_skip_files=True
    )


def accuracy(results, paths, op_truth, end_truth, tol=8.0):
    ok = 0
    for r, (op_s, op_e), en in zip(results, op_truth, end_truth):
        good = (
            r.opening is not None
            and abs(r.opening[0].as_secs_f64() - op_s) < tol
            and abs(r.opening[1].as_secs_f64() - op_e) < tol
        )
        if en is not None:
            good = good and (
                r.ending is not None
                and abs(r.ending[0].as_secs_f64() - en[0]) < tol
                and abs(r.ending[1].as_secs_f64() - en[1]) < tol
            )
        ok += bool(good)
    return ok / max(1, len(results))


def search_only_config(n_eps: int, n_shows: int = 1) -> None:
    """BASELINE config 3: search-only over a large pre-hashed library
    (no decode). Prints one JSON line. NEEDLE_BENCH_CONFIG=search300.

    n_shows > 1 (NEEDLE_BENCH_CONFIG=mixedN, 20 shows) models the
    realistic whole-library scan the reference's all-pairs Comparator
    supports: episodes of DIFFERENT shows share nothing, so only
    1/n_shows of the pair quadratic is related — the shape the pair
    prefilter (search/prefilter.py) exists for."""
    from needle_tpu import Comparator

    fhs = search_library(n_eps, n_shows)
    warm_device()
    cmp = Comparator.from_files(
        [f"ep{k:04}.mkv" for k in range(n_eps)], engine="jax"
    )
    times, trial_stages = [], []
    results = None
    pairs = n_eps * (n_eps - 1) // 2
    lib_desc = (
        f"{n_eps}-episode library"
        if n_shows == 1
        else f"{n_eps}-episode {n_shows}-show mixed library"
    )
    for _ in range(max(1, TRIALS)):
        snap0 = _stage_snapshot()
        t0 = time.time()
        results = cmp.run_with_frame_hashes(
            fhs, display=False, use_skip_files=False, write_skip_files=False
        )
        times.append(time.time() - t0)
        trial_stages.append(_stage_delta(snap0, _stage_snapshot()))
    from needle_tpu.tracing import report_metrics

    report_metrics()  # set NEEDLE_TPU_TIMINGS=1 for the stage table
    found = sum(1 for r in results if r.opening is not None)
    best = min(times)
    emit_result(
        {
            "metric": f"search-only wall, {lib_desc} "
            f"({pairs} pairs), 1 chip",
            "value": round(best, 4),
            "unit": "s",
            "vs_baseline": round(
                best / (BASELINE_SEARCH_S * pairs / 378.0), 4
            ),
            "pairs_per_sec": round(pairs / best, 1),
            "episodes_matched": found,
            "trials_s": [round(t, 3) for t in times],
            "stages_per_trial_s": trial_stages,
            "trials": TRIALS,
        }
    )


def search_library(n_eps: int, n_shows: int = 1):
    """The search-only configs' pre-hashed library: 2400 hashes (~10 min
    of opening window) per episode, each show's episodes sharing a ~90 s
    run at an episode-dependent offset; made from seed 11."""
    from needle_tpu.data import FrameHashes
    from needle_tpu.duration import Duration

    rng = np.random.default_rng(11)
    step = 247619033  # ~0.248 s/hash in ns
    n_hashes = 2400
    shareds = [
        rng.integers(0, 2**32, size=360, dtype=np.uint32)  # ~90 s
        for _ in range(n_shows)
    ]
    fhs = []
    for e in range(n_eps):
        h = rng.integers(0, 2**32, size=n_hashes, dtype=np.uint32)
        at = 40 + (e % 11) * 60
        shared = shareds[e % n_shows]
        h[at : at + len(shared)] = shared
        ts = (2600090703 + np.arange(n_hashes) * step).astype(np.int64)
        fhs.append(
            FrameHashes(h, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64),
                        Duration.from_millis(300), f"{e:032x}")
        )
    return fhs


def small3_config() -> None:
    """BASELINE config 1: 3 episodes (~24 min each) of pre-decoded 16 kHz
    mono PCM (.pcm raw files), analyze + pairwise search end-to-end."""
    from needle_tpu.testing import make_synthetic_season

    cache = REPO / ".bench_cache" / f"small3_s{SEED}"
    if not (cache / "ep01.pcm").exists():
        cache.mkdir(parents=True, exist_ok=True)
        paths, op_t, en_t = make_synthetic_season(
            cache, num_episodes=3, episode_secs=1440.0, opening_secs=85.0,
            ending_secs=70.0, rate=16000, seed=SEED,
        )
        # convert the WAVs to raw .pcm (16 kHz mono i16), the pre-decoded
        # input format of this config
        from needle_tpu.ingest import read_wav

        truths = {"opening": op_t, "ending": en_t}
        for p in paths:
            samples, _, _ = read_wav(p)
            samples.astype(np.int16).tofile(cache / (p.stem + ".pcm"))
            p.unlink()
        (cache / "TRUTH.json").write_text(json.dumps(truths))
    truths = json.loads((cache / "TRUTH.json").read_text())
    paths = sorted(cache.glob("*.pcm"))

    from needle_tpu.duration import Duration

    hash_duration = Duration.from_secs_f32(np.float32(0.3))
    warm_device()
    times_a, times_s = [], []
    results = None
    for _ in range(max(1, TRIALS)):
        t0 = time.time()
        run_analyze(paths, hash_duration)
        times_a.append(time.time() - t0)
        t0 = time.time()
        results = run_search(paths)
        times_s.append(time.time() - t0)
    total = min(times_a) + min(times_s)
    acc = accuracy(results, paths, truths["opening"], truths["ending"])
    emit_result(
        {
            "metric": "analyze+search wall, 3 x 24-min pre-decoded "
            "16 kHz PCM episodes, 1 chip",
            "value": round(total, 4),
            "unit": "s",
            "vs_baseline": round(total / 11.0, 4),  # ~10s + <1s, M1 (README.md:96)
            "analyze_s": round(min(times_a), 4),
            "search_s": round(min(times_s), 4),
            "value_total_min": round(
                min(a + s for a, s in zip(times_a, times_s)), 4
            ),
            "accuracy_vs_truth": round(acc, 4),
            "analyze_trials_s": [round(t, 3) for t in times_a],
            "search_trials_s": [round(t, 3) for t in times_s],
            "trials": TRIALS,
        }
    )


def main():
    config = os.environ.get("NEEDLE_BENCH_CONFIG", "")
    if config.startswith("search"):
        search_only_config(int(config[len("search"):] or 300))
        return
    if config.startswith("mixed"):
        # 20-show library: only ~5% of the pair quadratic is related
        search_only_config(int(config[len("mixed"):] or 1000), n_shows=20)
        return
    if config == "small3":
        small3_config()
        return

    t_setup0 = time.time()
    paths, op_truth, end_truth = build_season()
    # Prewarm the page cache (untimed): the analyzer reads WAV payloads via
    # memmap, so a cold cache turns batch assembly into random disk faults
    # and benchmarks the disk, not the pipeline. The reference's published
    # numbers are warm-cache too.
    for p in paths:
        with open(p, "rb") as f:
            while f.read(1 << 22):
                pass
    setup_s = time.time() - t_setup0

    from needle_tpu.duration import Duration

    hash_duration = Duration.from_secs_f32(np.float32(0.3))
    warm_device()

    analyze_times, search_times, trial_stages = [], [], []
    results = None
    for _ in range(max(1, TRIALS)):
        snap0 = _stage_snapshot()
        t0 = time.time()
        run_analyze(paths, hash_duration)
        analyze_times.append(time.time() - t0)
        snap1 = _stage_snapshot()
        t0 = time.time()
        results = run_search(paths)
        search_times.append(time.time() - t0)
        snap2 = _stage_snapshot()
        _da, _ds = _stage_delta(snap0, snap1), _stage_delta(snap1, snap2)
        _counts = {**_da.pop("counts", {}), **_ds.pop("counts", {})}
        _merged = {**_da, **_ds}
        if _counts:
            _merged["counts"] = _counts
        trial_stages.append(_merged)

    acc = accuracy(results, paths, op_truth, end_truth)
    from needle_tpu.tracing import report_metrics

    report_metrics()  # stage table when NEEDLE_TPU_TIMINGS=1
    t_analyze = min(analyze_times)
    t_search = min(search_times)
    total = t_analyze + t_search
    best_i = min(
        range(len(analyze_times)),
        key=lambda i: analyze_times[i] + search_times[i],
    )
    best_bytes = trial_stages[best_i].get("counts", {}).get(
        "ingest.upload_bytes"
    )
    emit_result(
        {
            "metric": "analyze+search wall, 28-ep season (~20 min/ep), 1 chip",
            "value": round(total, 4),
            "unit": "s",
            "vs_baseline": round(total / BASELINE_TOTAL_S, 4),
            "speedup_vs_reference": round(BASELINE_TOTAL_S / total, 2),
            # min over SINGLE-trial totals: a number one run actually
            # produced, next to the composed min(analyze)+min(search)
            "value_total_min": round(
                analyze_times[best_i] + search_times[best_i], 4
            ),
            "analyze_s": round(t_analyze, 4),
            "search_s": round(t_search, 4),
            "baseline_analyze_s": BASELINE_ANALYZE_S,
            "baseline_search_s": BASELINE_SEARCH_S,
            "accuracy_vs_truth": round(acc, 4),
            "minutes_audio_per_sec_analyze": round(
                NUM_EPISODES * EPISODE_SECS / 60.0 / t_analyze, 1
            ),
            "pairs_per_sec_search": round(
                NUM_EPISODES * (NUM_EPISODES - 1) / 2 / t_search, 1
            ),
            "bytes_uploaded_mb": (
                round(best_bytes / 1e6, 1) if best_bytes else None
            ),
            "decode_s": trial_stages[best_i].get("analyze.decode"),
            "setup_s": round(setup_s, 2),
            "analyze_trials_s": [round(t, 3) for t in analyze_times],
            "search_trials_s": [round(t, 3) for t in search_times],
            "stages_per_trial_s": trial_stages,
            "trials": TRIALS,
        }
    )


if __name__ == "__main__":
    main()
