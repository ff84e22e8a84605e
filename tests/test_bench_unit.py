"""Unit tests for bench.py: the headline/detail emitter, the warm-up,
the search-only library and the accuracy score.

The bench's last line is what a driver parses, so its emitter is worth
pinning: the headline must stay compact and parseable however large the
per-trial detail grows.
"""

import importlib
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def _bench():
    sys.path.insert(0, str(REPO))
    import bench

    return importlib.reload(bench)


def test_warm_device_is_one_plain_round_trip(monkeypatch):
    """The warm-up is a single device round trip: no probes, no loops,
    no watchdog threads left behind."""
    import threading

    import jax

    bench = _bench()
    calls = []
    real_put = jax.device_put
    monkeypatch.setattr(
        jax, "device_put", lambda x, *a, **k: calls.append(1) or real_put(x)
    )
    before = threading.active_count()
    bench.warm_device()
    assert calls == [1]
    assert threading.active_count() == before


def test_search_library_is_seeded_and_planted():
    bench = _bench()
    a = bench.search_library(6, n_shows=2)
    b = bench.search_library(6, n_shows=2)
    assert len(a) == 6
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.opening_hashes, y.opening_hashes)
        assert len(x.opening_hashes) == 2400
        assert len(x.ending_hashes) == 0
    # episodes of one show share the planted 360-hash run
    h0, h2 = a[0].opening_hashes, a[2].opening_hashes
    np.testing.assert_array_equal(h0[40:400], h2[160:520])


def test_accuracy_counts_within_tolerance():
    from types import SimpleNamespace

    from needle_tpu.duration import Duration

    bench = _bench()

    def res(op, en):
        d = lambda t: (Duration.from_secs_f64(t[0]), Duration.from_secs_f64(t[1]))
        return SimpleNamespace(opening=d(op), ending=None if en is None else d(en))

    truth_op = [(10.0, 95.0), (20.0, 105.0)]
    truth_en = [(1000.0, 1070.0), None]
    results = [res((12.0, 96.0), (1001.0, 1069.0)), res((40.0, 105.0), None)]
    assert bench.accuracy(results, [0, 1], truth_op, truth_en) == 0.5


def _bloated_base():
    """A season-result dict with six ~700 B per-trial stage dicts in the
    same object as the headline fields."""
    stage = {
        "ingest.read_raw": 0.006, "ingest.batch_assemble": 3.442,
        "ingest.upload": 33.982, "ingest.dispatch": 32.582,
        "ingest.collect": 6.668, "ingest.rescan": 1.076,
        "analyze.decode": 65.252, "analyze.fingerprint": 12.527,
        "analyze.assemble": 0.024, "search.pairs": 0.608,
        "search.prefilter": 0.0, "search.launch": 0.03,
        "search.collect": 0.404, "search.collect_device": 0.184,
        "search.collect_unpack": 0.029, "search.extract": 0.19,
        "counts": {"search.extract_diags": 1561,
                   "ingest.upload_bytes": 537_000_000},
    }
    return {
        "metric": "analyze+search wall, 28-ep season (~20 min/ep), 1 chip",
        "value": 8.28, "unit": "s", "vs_baseline": 0.4705,
        "speedup_vs_reference": 2.13, "value_total_min": 9.1,
        "analyze_s": 7.6, "search_s": 0.68, "accuracy_vs_truth": 1.0,
        "bytes_uploaded_mb": 537.0,
        "minutes_audio_per_sec_analyze": 1.2,
        "pairs_per_sec_search": 556.0,
        "trials": 5, "trials_run": 6,
        "setup_s": 12.3,
        "analyze_trials_s": [7.6, 42.1, 100.3, 55.0, 30.2, 9.0],
        "search_trials_s": [0.68] * 6,
        "stages_per_trial_s": [stage] * 6,
    }


def test_emit_result_final_line_is_compact_headline(capsys):
    """The LAST stdout line must parse and fit the driver's tail capture;
    the stage breakdowns must ride a separate, earlier detail line."""
    import json

    bench = _bench()
    bench.emit_result(_bloated_base())
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2
    head = json.loads(lines[-1])
    assert len(lines[-1].encode()) <= bench.HEADLINE_BUDGET_B
    assert head["value"] == 8.28
    assert head["vs_baseline"] == 0.4705
    assert head["value_total_min"] == 9.1
    assert head["bytes_uploaded_mb"] == 537.0
    assert "stages_per_trial_s" not in head
    detail = json.loads(lines[0])
    assert detail["stages_per_trial_s"][0]["ingest.upload"] == 33.982
    assert detail["detail_for"] == head["metric"]


def test_emit_result_headline_never_exceeds_budget(capsys):
    """Even pathological field sizes (giant error text, absurd metric)
    must shrink to <= HEADLINE_BUDGET_B with the core fields intact."""
    import json

    bench = _bench()
    base = _bloated_base()
    base["partial"] = True
    base["error"] = "run failed: " + "x" * 5000
    bench.emit_result(base)
    lines = capsys.readouterr().out.strip().splitlines()
    head = json.loads(lines[-1])
    assert len(lines[-1].encode()) <= bench.HEADLINE_BUDGET_B
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in head
    # the diagnostic flags must survive trimming: a failed run stays
    # distinguishable from a clean result
    assert head["partial"] is True
    assert head["error"].startswith("run failed:")


def test_emit_result_no_detail_when_compact(capsys):
    """A base that is already headline-only prints exactly one line."""
    import json

    bench = _bench()
    bench.emit_result(
        {"metric": "m", "value": 1.0, "unit": "s", "vs_baseline": 0.5}
    )
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["value"] == 1.0
