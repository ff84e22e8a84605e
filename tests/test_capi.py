"""C API (capi/libneedle_tpu_capi.so) — the needle-capi equivalent.

Exercises the C ABI from a separate C program (compiled on the fly) so the
embedded-interpreter path is tested exactly as a C consumer would use it.
Mirrors the reference's C API smoke tests (needle-capi/src/lib.rs:639-740)
plus an end-to-end search the reference lacks.
"""

import os
import shutil
import subprocess
from pathlib import Path

import pytest

from needle_tpu.testing import make_synthetic_season

REPO = Path(__file__).resolve().parent.parent
CAPI = REPO / "capi"


@pytest.fixture(scope="module")
def capi_lib():
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable")
    r = subprocess.run(["make", "-C", str(CAPI)], capture_output=True, text=True)
    if r.returncode != 0:
        pytest.fail(f"capi build failed:\n{r.stderr}")
    return CAPI / "libneedle_tpu_capi.so"


@pytest.fixture(scope="module")
def capi_env():
    """Subprocess env: embedded interpreter pinned to the CPU, so no child
    opens a GPU."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    env["NEEDLE_TPU_PYTHON_ROOT"] = str(REPO)
    return env


@pytest.fixture(scope="module")
def example_bins(capi_lib):
    r = subprocess.run(
        ["make", "-C", str(CAPI / "examples")], capture_output=True, text=True
    )
    if r.returncode != 0:
        pytest.fail(f"capi examples build failed:\n{r.stderr}")
    return CAPI / "examples"


def test_capi_full_pipeline(example_bins, capi_env, tmp_path):
    season = tmp_path / "season"
    _, op_truth, _ = make_synthetic_season(
        season, num_episodes=3, episode_secs=100, opening_secs=25, seed=4242
    )
    r = subprocess.run(
        [str(example_bins / "full"), str(season)],
        capture_output=True,
        text=True,
        env=capi_env,
        timeout=600,
    )
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "found 3 videos" in r.stdout
    assert "* Opening - " in r.stdout
    # analyzer persisted hashes; comparator wrote skip files
    assert len(list(season.glob("*.needle.dat"))) == 3
    assert len(list(season.glob("*.needle.skip.json"))) == 3


def test_capi_error_paths(capi_lib, capi_env, tmp_path):
    """Constructor validation via ctypes (null/invalid arguments)."""
    import ctypes

    lib = ctypes.CDLL(str(capi_lib))
    lib.needle_error_to_str.restype = ctypes.c_char_p

    # Error strings exist for all 12 variants.
    for code in range(12):
        s = lib.needle_error_to_str(code)
        assert s and len(s) > 0

    # NULL arguments.
    NULL = None
    assert lib.needle_audio_analyzer_new_default(NULL, 0, NULL) == 2  # NullArgument

    # Comparator requires >= 2 paths.
    out = ctypes.c_void_p()
    arr = (ctypes.c_char_p * 1)(b"/tmp/a.mkv")
    rc = lib.needle_audio_comparator_new_default(arr, 1, ctypes.byref(out))
    assert rc == 7  # ComparatorMinimumPaths

    # Invalid hash threshold.
    arr2 = (ctypes.c_char_p * 2)(b"/tmp/a.mkv", b"/tmp/b.mkv")
    rc = lib.needle_audio_comparator_new(
        arr2, 2, False, 33, 20, 20, ctypes.c_float(0.0), ctypes.byref(out)
    )
    assert rc == 3  # InvalidArgument
