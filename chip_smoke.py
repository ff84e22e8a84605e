#!/usr/bin/env python3
"""On-card smoke test: the season's analyze + search on an NVIDIA GPU,
through the entry points a user calls, checked against the repo's own
oracles.

    python3 chip_smoke.py           # one card
    python3 chip_smoke.py --multi   # four cards: the season under a 4-card mesh

One card runs five phases in order: device, analyze, margin, search and
kernels. `--multi` runs the device phase and then only the multi phase.
Each phase prints one JSON line of its findings, with the card's name and
power limit beside every time. The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

and it is printed only when every check of every phase passed. A failed
check raises, so the script exits non-zero. Without a GPU it exits
non-zero before any phase runs; nothing falls back to the CPU.

The season is bench.py's: 28 episodes of 20 minutes, 16 kHz mono WAV
made from a seed under .bench_cache/ (about 1.08 GB).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))
# the season is WAV; discovery accepts audio-only inputs on opt-in
os.environ.setdefault("NEEDLE_TPU_ALLOW_AUDIO", "1")

import numpy as np  # noqa: E402

import jax  # noqa: E402

from needle_tpu import _jax_setup  # noqa: E402

SEED = 20260816
ORACLE_EPISODES = 3  # analyzed episodes checked against the host oracle
LIBRARY_EPISODES = 300  # bench.py's search-only library
ORACLE_PAIRS = 64  # library pairs checked against the NumPy engine
PARITY_TRIALS = 6  # random libraries of tools/hw_parity.py
WALK_REPS = 7  # warm timed runs per walk formulation
WALK_PAIRS = 1 << 30  # pairs per timed dispatch, capped at the engine's chunk
MULTI_CARDS = 4


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def require_gpu(devices) -> None:
    platforms = sorted({d.platform for d in devices})
    if platforms != ["gpu"]:
        raise SystemExit(
            f"chip_smoke: needs NVIDIA GPUs; JAX sees {platforms or 'none'}"
        )


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": d.platform,
                "kind": d.device_kind,
                "count": len(devices),
            },
        }
    )


def card_lines() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def emit(phase: str, card: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": card, **fields}), flush=True)


def _counter(snapshot, name: str) -> float:
    return snapshot.get(name, (0.0, 0))[0]


def _counter_delta(before, after, name: str) -> float:
    return _counter(after, name) - _counter(before, name)


@contextlib.contextmanager
def _env(name: str, value: str):
    prev = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _hash_duration():
    from needle_tpu.constants import DEFAULT_HASH_DURATION
    from needle_tpu.duration import Duration

    return Duration.from_secs_f32(np.float32(DEFAULT_HASH_DURATION))


def run_cli(argv) -> str:
    """`python -m needle_tpu.cli <argv>` in this process (a second
    process could not open the card); returns what it printed."""
    from needle_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main([str(a) for a in argv])
    check(rc == 0, f"needle {argv[0]} exited {rc}")
    return out.getvalue()


def clear_outputs(paths) -> None:
    from needle_tpu.data import frame_hash_data_path, skip_file_path

    for p in paths:
        for f in (frame_hash_data_path(p), skip_file_path(p)):
            f.unlink(missing_ok=True)


def skip_bytes(paths) -> dict:
    from needle_tpu.data import skip_file_path

    return {p.name: skip_file_path(p).read_bytes() for p in paths
            if skip_file_path(p).exists()}


def load_season():
    """bench.py's season, made on first use; stale outputs removed."""
    import bench

    t0 = time.perf_counter()
    paths, op_truth, end_truth = bench.build_season()
    clear_outputs(paths)
    return paths, op_truth, end_truth, time.perf_counter() - t0


def info_rows(infos) -> list:
    import hw_parity

    return [hw_parity.info_fields(i) for i in infos]


def mismatched(got, want) -> list:
    return [k for k, (g, w) in enumerate(zip(got, want)) if g != w]


# -- phases -------------------------------------------------------------------


def phase_device(card: str, devices) -> None:
    emit(
        "device", card,
        jax=jax.__version__,
        xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=_jax_setup.cache_dir(),
        devices=[d.device_kind for d in devices],
        count=len(devices),
    )


def oracle_hashes(path, side: str) -> np.ndarray:
    """Hashes of one episode side from the canonical host oracle of the
    fused ingest path (fingerprint/ingest_oracle.py), over the analyzer's
    own window and with its own hash selection."""
    from needle_tpu.analyzer import Analyzer
    from needle_tpu.fingerprint.ingest_oracle import ingest_hashes_full_oracle
    from needle_tpu.fingerprint.jax_impl import (
        IngestDispatcher,
        _bucket_frames,
        resampled_length,
    )
    from needle_tpu.fingerprint.numpy_impl import (
        num_frames,
        num_subfingerprints,
    )

    an = Analyzer.from_files([path], backend="jax").with_include_endings(True)
    op_seg, op_nv, en_seg, en_nv, rate, channels, _ = an._raw_segments(path)
    seg, nv = (op_seg, op_nv) if side == "opening" else (en_seg, en_nv)
    dec = IngestDispatcher(rate, channels).dec_factor
    n_res = resampled_length(
        ((nv // channels) // dec) * channels, rate // dec, channels
    )
    raw = ingest_hashes_full_oracle(
        np.asarray(seg), nv, rate, channels, dec,
        _bucket_frames(num_frames(n_res)), num_subfingerprints(n_res),
    )
    return Analyzer._hashes_with_timestamps(raw, _hash_duration(), None)[0]


def phase_analyze(card: str, paths) -> list:
    from needle_tpu.data import FrameHashes, frame_hash_data_path
    from needle_tpu.tracing import metrics

    before = metrics.snapshot()
    t0 = time.perf_counter()
    run_cli(["analyze", "--file-headers-only", "--include-endings", "--force",
             paths[0].parent])
    wall = time.perf_counter() - t0
    after = metrics.snapshot()
    fhs = [FrameHashes.from_path(frame_hash_data_path(p)) for p in paths]
    check(
        all(len(f.opening_hashes) and len(f.ending_hashes) for f in fhs),
        "analyze: an episode has no opening or ending hashes",
    )
    picks = sorted(
        int(i) for i in np.random.default_rng(SEED).choice(
            len(paths), ORACLE_EPISODES, replace=False
        )
    )
    checked = []
    for i in picks:
        for side in ("opening", "ending"):
            want = oracle_hashes(paths[i], side)
            got = getattr(fhs[i], f"{side}_hashes")
            check(
                len(got) == len(want) and np.array_equal(got, want),
                f"analyze: {paths[i].name} {side} hashes differ from the "
                "host oracle",
            )
            checked.append(f"{paths[i].name}:{side}:{len(got)}")
    hashes = _counter_delta(before, after, "ingest.hashes")
    flagged = _counter_delta(before, after, "ingest.rescan_flagged")
    emit(
        "analyze", card,
        entry="needle analyze --include-endings",
        episodes=len(paths),
        wall_s_incl_compile=wall,
        opening_hashes=len(fhs[0].opening_hashes),
        ending_hashes=len(fhs[0].ending_hashes),
        device_hashes=int(hashes),
        rescan_flagged=int(flagged),
        rescan_flag_rate=flagged / max(hashes, 1.0),
        oracle_bit_exact=checked,
    )
    return fhs


def phase_margin(card: str) -> None:
    import hw_parity
    from needle_tpu.fingerprint.jax_impl import _PREC, _exact_eps

    rng = np.random.default_rng(20260817)
    eps = _exact_eps()
    limit = 0.5 * eps
    t0 = time.perf_counter()
    pre = hw_parity.validate_exact_eps(rng, seconds=120.0)
    ing = hw_parity.validate_ingest_eps(rng)
    hashes = hw_parity.hash_bit_exactness(rng)
    ingest_hashes = hw_parity.ingest_hash_exactness(rng)
    wall = time.perf_counter() - t0
    for name, st in (("pre-decoded", pre), ("ingest", ing)):
        check(st["small_norm_frames"] > 0, f"margin: {name} has no small norms")
        check(
            max(st["max_value_err"], st["max_norm_err_small"]) < limit,
            f"margin: {name} error {st} not below {limit}",
        )
    for name, res in (("pre-decoded", hashes), ("ingest", ingest_hashes)):
        for kind, r in res.items():
            check(
                r["hashes_differing"] == 0,
                f"margin: {name} {kind} hashes differ from the host oracle",
            )
    emit(
        "margin", card,
        eps=eps,
        tolerance=limit,
        precision=str(_PREC),
        pre_decoded=pre,
        ingest=ing,
        hash_parity=hashes,
        ingest_hash_parity=ingest_hashes,
        wall_s=wall,
    )


def phase_search(card: str, paths, op_truth, end_truth, fhs):
    import bench
    from needle_tpu import Comparator

    season_dir = paths[0].parent
    t0 = time.perf_counter()
    shown = run_cli(["search", "--file-headers-only", "--include-endings",
                     "--write-skip-files", season_dir])
    cli_wall = time.perf_counter() - t0
    jax_skip = skip_bytes(paths)
    check(len(jax_skip) == len(paths), "search: skip files missing")

    pairs = Comparator.pair_order(len(paths))
    cmp_j = Comparator.from_files(paths, engine="jax").with_include_endings(
        True
    )
    t0 = time.perf_counter()
    infos_j = cmp_j.search_pair_infos(fhs, pairs)
    jax_wall = time.perf_counter() - t0

    # the NumPy engine (reference semantics) over links to the same media,
    # so its skip files land beside the links
    oracle_dir = season_dir.parent / "chip_smoke_oracle"
    shutil.rmtree(oracle_dir, ignore_errors=True)
    oracle_dir.mkdir(parents=True)
    links = []
    for p in paths:
        (oracle_dir / p.name).symlink_to(p)
        links.append(oracle_dir / p.name)
    cmp_n = Comparator.from_files(links, engine="numpy").with_include_endings(
        True
    )
    t0 = time.perf_counter()
    infos_n = cmp_n.search_pair_infos(fhs, pairs)
    numpy_wall = time.perf_counter() - t0
    rows_j, rows_n = info_rows(infos_j), info_rows(infos_n)
    bad = mismatched(rows_j, rows_n)
    check(not bad, f"search: RunEntry lists differ on pairs {bad[:8]}")

    def data(infos):
        return [(i, j, info) for (i, j), info in zip(pairs, infos)
                if not info.is_empty()]

    cmp_n.finalize_results(data(infos_n), False, False, True)
    numpy_skip = skip_bytes(links)
    check(numpy_skip == jax_skip, "search: skip files differ from NumPy's")
    results = cmp_j.finalize_results(data(infos_j), False, False, False)
    acc = bench.accuracy(results, paths, op_truth, end_truth)
    found = len(results)
    check(
        found == len(paths) and acc == 1.0,
        f"search: {found} episodes matched, accuracy {acc}",
    )
    shutil.rmtree(oracle_dir)
    emit(
        "search", card,
        entry="needle search --include-endings --write-skip-files",
        pairs=len(pairs),
        pairs_vs_numpy=len(pairs),
        runentry_identical=True,
        skip_files_identical=len(jax_skip),
        accuracy=f"{round(acc * found)}/{len(paths)}",
        display_lines=len(shown.splitlines()),
        cli_wall_s_incl_compile=cli_wall,
        jax_search_warm_s=jax_wall,
        numpy_search_s=numpy_wall,
    )
    return pairs, rows_n


def walk_timings(fhs, pairs) -> dict:
    """Warm median of each walk formulation at the season's opening
    shape: n_pad of its opening side and one full chunk of its pairs."""
    from needle_tpu.constants import (
        DEFAULT_HASH_MATCH_THRESHOLD,
        DEFAULT_MIN_OPENING_DURATION,
    )
    from needle_tpu.search import jax_impl as S
    from needle_tpu.search import triton_walk
    from needle_tpu.search.geometry import full_block_mask, n_groups_for

    sides = [f.opening_hashes for f in fhs]
    n_pad = S._bucket(max(len(h) for h in sides))
    table = np.zeros((S._bucket(len(sides)), n_pad), np.uint32)
    vtab = np.zeros(table.shape, bool)
    for s, h in enumerate(sides):
        table[s, : len(h)] = h
        vtab[s, 1 : len(h)] = True
    spacing = max(int(np.max(np.diff(f.opening_ts_nanos))) for f in fhs)
    l_min = -(-DEFAULT_MIN_OPENING_DURATION * 10**9 // spacing)
    td, vd = jax.device_put(table), jax.device_put(vtab)
    threshold = DEFAULT_HASH_MATCH_THRESHOLD
    out = {"n_pad": n_pad, "l_min": l_min, "threshold": threshold}
    masks = {}
    for kernel in S._KERNELS:
        chunk = S._chunk_size(kernel, n_pad, WALK_PAIRS)
        sel = [pairs[k % len(pairs)] for k in range(chunk)]
        ia = jax.numpy.asarray([a for a, _ in sel], np.int32)
        ib = jax.numpy.asarray([b for _, b in sel], np.int32)
        lm = jax.numpy.full((chunk,), l_min, np.int32)
        if kernel == "triton":
            bm = jax.numpy.asarray(
                np.full((chunk, n_groups_for(n_pad)), full_block_mask(n_pad),
                        np.int32)
            )

            def run():
                return S._batch_walk_bitmask(
                    td, vd, ia, ib, lm, bm, threshold, n_pad,
                    interpret=triton_walk.INTERPRET,
                )
        else:
            mxu = kernel == "mxu"

            def run():
                return S._batch_tiles_indexed(td, vd, ia, ib, lm, threshold,
                                              n_pad, mxu=mxu)
        t0 = time.perf_counter()
        first = run().block_until_ready()
        compile_s = time.perf_counter() - t0
        times = []
        for _ in range(WALK_REPS):
            t0 = time.perf_counter()
            run().block_until_ready()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        bits = np.unpackbits(np.asarray(first), axis=1, bitorder="little")
        masks[kernel] = bits[:, : 2 * n_pad - 1]
        out[kernel] = {
            "chunk": chunk,
            "first_call_s": compile_s,
            "warm_median_s": med,
            "warm_s": times,
            "us_per_pair": med / chunk * 1e6,
        }
    common = min(len(m) for m in masks.values())
    ref = masks["tiles"][:common]
    check(
        all(np.array_equal(m[:common], ref) for m in masks.values()),
        "kernels: walk formulations flag different diagonals",
    )
    out["flagged_diagonals_agree"] = True
    return out


def season_search_ab(fhs, pairs, rows_n) -> dict:
    """Season search wall per walk formulation, warm, in the order
    triton, tiles, tiles, triton after one warm-up run of each."""
    from needle_tpu import Comparator
    from needle_tpu.search import jax_impl as S

    cmp = Comparator.from_files(
        [f"v{k}.mkv" for k in range(len(fhs))], engine="jax"
    ).with_include_endings(True)
    walls = {"triton": [], "tiles": []}
    prev = S._KERNEL
    try:
        for kernel, timed in (("triton", False), ("tiles", False),
                              ("triton", True), ("tiles", True),
                              ("tiles", True), ("triton", True)):
            S._KERNEL = kernel
            t0 = time.perf_counter()
            rows = info_rows(cmp.search_pair_infos(fhs, pairs))
            if timed:
                walls[kernel].append(time.perf_counter() - t0)
            check(rows == rows_n,
                  f"kernels: season search with {kernel} differs from NumPy")
    finally:
        S._KERNEL = prev
    return {k: {"warm_s": v, "mean_s": float(np.mean(v))}
            for k, v in walls.items()}


def phase_kernels(card: str, fhs, pairs, rows_n) -> None:
    import bench
    import hw_parity
    from needle_tpu import Comparator
    from needle_tpu.tracing import metrics

    t0 = time.perf_counter()
    libs = hw_parity.make_libraries(
        np.random.default_rng(20260817), PARITY_TRIALS
    )
    legs = {}
    for kernel in hw_parity.KERNELS:
        bad, n = [], 0
        for name, lib, thr, mo, endings in libs:
            want = hw_parity.run_engine(lib, thr, mo, endings, "numpy")
            got = hw_parity.run_engine(lib, thr, mo, endings, "jax",
                                       kernel=kernel)
            n += len(got)
            if got != want:
                bad.append(name)
        check(not bad, f"kernels: {kernel} differs from NumPy on {bad}")
        legs[kernel] = n
    # the band masks by both of their paths (their int32 einsums run only
    # there): per-pair gathers and episode-tile correlation
    pf = {}
    for path, dense in (("per_pair", "off"), ("episode_tiles", "on")):
        with _env("NEEDLE_TPU_PREFILTER_DENSE", dense):
            pf[path] = hw_parity.prefilter_parity(
                np.random.default_rng(20260818)
            )
        check(pf[path]["exact"] and pf[path]["pairs_skipped"] > 0,
              f"kernels: prefilter ({path}) {pf[path]}")
    dr = hw_parity.direct_parity(np.random.default_rng(20260818))
    check(dr["exact"] and dr["direct_items"] > 0, f"kernels: direct {dr}")
    parity_wall = time.perf_counter() - t0

    # the search-only library at full width
    n_eps = LIBRARY_EPISODES
    lib = bench.search_library(n_eps)
    pairs300 = Comparator.pair_order(n_eps)
    names = [f"ep{k:04}.mkv" for k in range(n_eps)]
    before = metrics.snapshot()
    t0 = time.perf_counter()
    infos = Comparator.from_files(names, engine="jax").search_pair_infos(
        lib, pairs300
    )
    wall300 = time.perf_counter() - t0
    after = metrics.snapshot()
    subset = sorted(
        int(k) for k in np.random.default_rng(SEED).choice(
            len(pairs300), ORACLE_PAIRS, replace=False
        )
    )
    want = info_rows(
        Comparator.from_files(names, engine="numpy").search_pair_infos(
            lib, [pairs300[k] for k in subset]
        )
    )
    got = info_rows([infos[k] for k in subset])
    bad = mismatched(got, want)
    check(not bad, f"kernels: library pairs {bad[:8]} differ from NumPy")
    found = sum(1 for i in infos if not i.is_empty())

    walk = walk_timings(fhs, pairs)
    ab = season_search_ab(fhs, pairs, rows_n)
    emit(
        "kernels", card,
        parity_pair_infos=legs,
        prefilter=pf,
        direct=dr,
        parity_wall_s=parity_wall,
        library={
            "episodes": n_eps,
            "pairs": len(pairs300),
            "pairs_with_runs": found,
            "pairs_vs_numpy": len(subset),
            "runentry_identical": True,
            "prefilter_skipped": int(_counter_delta(
                before, after, "search.prefilter_skipped")),
            "direct_items": int(_counter_delta(
                before, after, "search.direct_items")),
            "wall_s_incl_compile": wall300,
        },
        walk=walk,
        season_search=ab,
    )


def season_run(paths, pairs) -> tuple:
    """Analyze and search the season through the library API; returns
    (per-episode hashes, RunEntry rows, skip-file bytes)."""
    from needle_tpu import Analyzer, Comparator

    clear_outputs(paths)
    fhs = (
        Analyzer.from_files(paths, force=True, backend="jax")
        .with_include_endings(True)
        .run(_hash_duration(), persist=True)
    )
    cmp = Comparator.from_files(paths, engine="jax").with_include_endings(True)
    infos = cmp.search_pair_infos(fhs, pairs)
    data = [(i, j, info) for (i, j), info in zip(pairs, infos)
            if not info.is_empty()]
    cmp.finalize_results(data, False, False, True)
    hashes = [(f.opening_hashes, f.ending_hashes) for f in fhs]
    return hashes, info_rows(infos), skip_bytes(paths)


def phase_multi(card: str, devices) -> None:
    from needle_tpu import Comparator
    from needle_tpu.parallel import needle_mesh
    from needle_tpu.search import jax_impl as S

    check(len(devices) >= MULTI_CARDS,
          f"multi: {len(devices)} GPUs visible, {MULTI_CARDS} needed")
    paths, _, _, setup_s = load_season()
    pairs = Comparator.pair_order(len(paths))
    t0 = time.perf_counter()
    one = season_run(paths, pairs)
    one_wall = time.perf_counter() - t0
    with needle_mesh(MULTI_CARDS) as mesh:
        kernel = S._kernel_choice()
        t0 = time.perf_counter()
        many = season_run(paths, pairs)
        many_wall = time.perf_counter() - t0
    check(
        all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            for a, b in zip(one[0], many[0])),
        "multi: hashes differ between one card and the mesh",
    )
    bad = mismatched(one[1], many[1])
    check(not bad, f"multi: RunEntry lists differ on pairs {bad[:8]}")
    check(len(one[2]) == len(paths) and one[2] == many[2],
          "multi: skip files differ between one card and the mesh")
    emit(
        "multi", card,
        mesh_devices=int(mesh.devices.size),
        mesh_kernel=kernel,
        episodes=len(paths),
        pairs=len(pairs),
        hashes_identical=True,
        runentry_identical=True,
        skip_files_identical=len(paths),
        season_setup_s=setup_s,
        one_card_wall_s_incl_compile=one_wall,
        mesh_wall_s_incl_compile=many_wall,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--multi", action="store_true",
        help=f"run the season on a {MULTI_CARDS}-card mesh against one card",
    )
    args = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    lines = card_lines()
    for ln in lines:
        print(ln, flush=True)
    card = lines[0] if len(set(lines)) == 1 else " | ".join(lines)
    _jax_setup.ensure()
    phase_device(card, devices)

    if args.multi:
        phase_multi(card, devices)
    else:
        paths, op_truth, end_truth, setup_s = load_season()
        emit("season", card, episodes=len(paths), setup_s=setup_s,
             bytes=sum(p.stat().st_size for p in paths))
        fhs = phase_analyze(card, paths)
        phase_margin(card)
        pairs, rows_n = phase_search(card, paths, op_truth, end_truth, fhs)
        phase_kernels(card, fhs, pairs, rows_n)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
