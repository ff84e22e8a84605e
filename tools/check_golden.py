#!/usr/bin/env python3
"""Verify a reference-produced `.needle.dat` against this implementation.

A one-command verifier: without the Rust reference binary (it needs
cargo) the byte format (data.rs:15-80) and the timestamp encoding
(analyzer.rs:286-318) were pinned from source reading plus golden tests
of BOTH candidate encodings. The moment a file produced by the actual reference binary is
available, run:

    python3 tools/check_golden.py GOLDEN.needle.dat [SOURCE_VIDEO]

and it will report, as machine-checkable JSON:

  * decode     — the file parses under our bincode-V1 layout
                 (version/variant indices, vec lengths, UTF-8 md5)
  * roundtrip  — our encoder reproduces the file byte-for-byte
  * ts_mode    — which timestamp encoding the file was written with:
                 "samples" (f64-exact chromaprint_get_delay()) or "ms"
                 (truncating chromaprint_get_delay_ms()). The two drift
                 ~0.81 ms per hash, so ~100 hashes are unambiguous; the
                 detector fits a constant offset (ending windows carry the
                 seek offset) and demands exact int64-nanos equality.
  * md5        — (with SOURCE_VIDEO) our header MD5 equals the file's key
  * hashes     — (with SOURCE_VIDEO) a fresh analyze of the video under
                 the detected ts mode reproduces the hash/timestamp arrays

Exit 0 iff every applicable check passes. If ts_mode detects "ms", flip
the default via NEEDLE_TPU_TS_MODE=ms (decision trail in STATUS.md).
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from needle_tpu.data import FrameHashes  # noqa: E402


def _expected_ts(mode: str, step_by: int, count: int) -> np.ndarray:
    """Reference timestamp table (delay + item*step_by*i) under `mode`."""
    from needle_tpu.analyzer import Analyzer

    prev = os.environ.get("NEEDLE_TPU_TS_MODE")
    os.environ["NEEDLE_TPU_TS_MODE"] = mode
    try:
        return Analyzer._ts_table(step_by, count).copy()
    finally:
        if prev is None:
            os.environ.pop("NEEDLE_TPU_TS_MODE", None)
        else:
            os.environ["NEEDLE_TPU_TS_MODE"] = prev


def detect_ts_mode(fh: FrameHashes) -> dict:
    """Which encoding produced `fh`'s timestamps?

    Returns {"mode": "samples"|"ms"|"ambiguous"|None, per-mode deviation}.
    A window matches a mode iff ts - expected is the SAME constant for
    every hash (openings: constant == 0; endings: the seek offset).
    """
    from needle_tpu.analyzer import chromaprint_delay_item

    # the analyzer's own stride constant (truncated as_millis is identical
    # in both modes, so the active env mode doesn't matter here)
    item_ms = int(chromaprint_delay_item()[1].as_millis())
    step_by = int(fh.hash_duration().as_millis()) // item_ms
    n_hashes = len(fh.opening_ts_nanos) + len(fh.ending_ts_nanos)
    if step_by == 0:
        # the reference panics on Iterator::step_by(0) (analyzer.rs), so no
        # genuine golden can carry a hash_duration shorter than the item
        return {
            "mode": None,
            "step_by": 0,
            "deviation_ns": {},
            "n_hashes": int(n_hashes),
            "error": "hash_duration shorter than chromaprint item duration",
        }
    out = {"mode": None, "step_by": step_by, "deviation_ns": {}}
    windows = [
        ("opening", fh.opening_ts_nanos, True),
        ("ending", fh.ending_ts_nanos, False),
    ]
    verdicts = {}
    for mode in ("samples", "ms"):
        worst = 0
        usable = 0
        for name, ts, zero_offset in windows:
            if len(ts) < 2:
                continue
            usable += len(ts)
            exp = _expected_ts(mode, step_by, len(ts))
            resid = ts.astype(np.int64) - exp
            off = resid[0] if not zero_offset else 0
            worst = max(worst, int(np.abs(resid - off).max()))
            if zero_offset:
                # opening windows start at t=0: the offset itself counts
                worst = max(worst, int(abs(resid[0])))
        verdicts[mode] = {"max_abs_deviation_ns": worst, "hashes": usable}
        out["deviation_ns"][mode] = worst
    exact = [m for m, v in verdicts.items() if v["max_abs_deviation_ns"] == 0]
    if len(exact) == 1:
        out["mode"] = exact[0]
    elif len(exact) == 2:
        out["mode"] = "ambiguous"  # only possible for very short windows
    out["n_hashes"] = int(n_hashes)
    return out


def check(dat_path: Path, video_path: Path | None) -> dict:
    report: dict = {"file": str(dat_path)}
    raw = dat_path.read_bytes()

    # 1. byte decode under the reference layout
    try:
        fh = FrameHashes.from_bytes(raw)
        report["decode"] = {
            "ok": True,
            "opening_hashes": int(len(fh.opening_hashes)),
            "ending_hashes": int(len(fh.ending_hashes)),
            "hash_duration_ms": int(fh.hash_duration().as_millis()),
            "md5": fh.md5(),
        }
    except Exception as e:  # needle Error subclasses included
        report["decode"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        report["ok"] = False
        return report

    # 2. encoder roundtrip: byte-identical re-encode
    enc = fh.to_bytes()
    report["roundtrip"] = {
        "ok": enc == raw,
        "bytes": len(raw),
        "reencoded_bytes": len(enc),
    }
    if enc != raw:
        diff_at = next(
            (i for i, (a, b) in enumerate(zip(enc, raw)) if a != b),
            min(len(enc), len(raw)),
        )
        report["roundtrip"]["first_diff_offset"] = diff_at

    # 3. timestamp-mode detection
    report["ts_mode"] = detect_ts_mode(fh)

    # 4./5. source-video checks
    if video_path is not None:
        # a missing/corrupt video must still produce the machine-checkable
        # report (only the .dat parse above is allowed to short-circuit)
        from needle_tpu.analyzer import Analyzer
        from needle_tpu.util import compute_header_md5sum

        try:
            md5 = compute_header_md5sum(video_path)
            report["md5"] = {"ok": md5 == fh.md5(), "computed": md5}
        except Exception as e:
            report["md5"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}

        mode = report["ts_mode"]["mode"]
        run_mode = mode if mode in ("samples", "ms") else "samples"
        prev = os.environ.get("NEEDLE_TPU_TS_MODE")
        os.environ["NEEDLE_TPU_TS_MODE"] = run_mode
        try:
            analyzer = Analyzer.from_files(
                [video_path], force=True
            ).with_include_endings(len(fh.ending_hashes) > 0)
            ours = analyzer.run(fh.hash_duration(), persist=False)[0]
        except Exception as e:
            ours = None
            report["hashes"] = {
                "ok": False,
                "analyzed_under_ts_mode": run_mode,
                "error": f"{type(e).__name__}: {e}",
            }
        finally:
            if prev is None:
                os.environ.pop("NEEDLE_TPU_TS_MODE", None)
            else:
                os.environ["NEEDLE_TPU_TS_MODE"] = prev
        if ours is not None:
            report["hashes"] = {
                "ok": bool(
                    np.array_equal(ours.opening_hashes, fh.opening_hashes)
                    and np.array_equal(ours.ending_hashes, fh.ending_hashes)
                    and np.array_equal(ours.opening_ts_nanos, fh.opening_ts_nanos)
                    and np.array_equal(ours.ending_ts_nanos, fh.ending_ts_nanos)
                ),
                "analyzed_under_ts_mode": run_mode,
                "opening_equal": bool(
                    np.array_equal(ours.opening_hashes, fh.opening_hashes)
                ),
                "ending_equal": bool(
                    np.array_equal(ours.ending_hashes, fh.ending_hashes)
                ),
            }

    checks = [v["ok"] for k, v in report.items() if isinstance(v, dict) and "ok" in v]
    ts_ok = report["ts_mode"]["mode"] in ("samples", "ms", "ambiguous")
    report["ok"] = bool(all(checks) and ts_ok)
    return report


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) > 2:
        print(__doc__)
        return 2
    dat = Path(argv[0])
    video = Path(argv[1]) if len(argv) == 2 else None
    report = check(dat, video)
    print(json.dumps(report, indent=2))
    ts = report.get("ts_mode") or {}
    print(json.dumps({"golden_check_ok": report["ok"], "file": str(dat),
                      "ts_mode": ts.get("mode")}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
