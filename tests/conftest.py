import os
import sys
from pathlib import Path

# Tests run on CPU with a virtual 8-device mesh so multi-device sharding
# code paths are exercised without a GPU. Tests that need the card carry
# the `gpu` marker and skip here (chip_smoke.py covers them on the card).
# NEEDLE_TPU_TEST_GPU=1 leaves the platform to JAX, for `-m gpu` runs on a
# GPU host.
ON_GPU = os.environ.get("NEEDLE_TPU_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
# Test fixtures are WAV/PCM seasons; discovery defaults to reference
# semantics (video stream required, util.rs:22-53) so tests opt in.
os.environ.setdefault("NEEDLE_TPU_ALLOW_AUDIO", "1")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Pin the platform at the config level too, so tests stay on the virtual
# 8-device CPU mesh even where JAX's CUDA plugin is installed.
import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is an NVIDIA GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py covers this on the card)")


@pytest.fixture(scope="session")
def chromaprint_available():
    from needle_tpu.fingerprint.oracle import available

    return available()


def require_chromaprint(chromaprint_available):
    if not chromaprint_available:
        pytest.skip("libchromaprint not installed")


@pytest.fixture(scope="session")
def sample_videos(tmp_path_factory):
    """Copies of the reference's bundled sample videos, or skip."""
    src = Path("/root/reference/needle/resources")
    files = [src / "sample-5s.mp4", src / "sample-shifted-4s.mp4"]
    if not all(f.exists() for f in files):
        pytest.skip("reference sample videos unavailable")
    d = tmp_path_factory.mktemp("samples")
    out = []
    for f in files:
        dst = d / f.name
        dst.write_bytes(f.read_bytes())
        out.append(dst)
    return out
