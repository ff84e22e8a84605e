"""Which device code runs: the search kernel choice per platform, the
`auto` engines (the JAX engines, with no silent NumPy fallback) and the
placement of the compilation cache."""

import sys

import jax
import pytest

from needle_tpu.search import jax_impl as S


@pytest.fixture
def auto_kernel(monkeypatch):
    monkeypatch.setattr(S, "_KERNEL", "auto")
    return S


def test_kernel_choice_cpu_is_tiles(auto_kernel):
    assert jax.default_backend() == "cpu"
    assert auto_kernel._kernel_choice() == "tiles"


def test_kernel_choice_gpu_is_triton(auto_kernel, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert auto_kernel._kernel_choice() == "triton"


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_kernel_choice_under_mesh_is_tiles(auto_kernel, monkeypatch, platform):
    from needle_tpu.parallel import needle_mesh

    with needle_mesh(2):
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert auto_kernel._kernel_choice() == "tiles"


@pytest.mark.parametrize("platform", ["rocm", "METAL"])
def test_kernel_choice_unknown_platform_raises(auto_kernel, monkeypatch,
                                                platform):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    with pytest.raises(RuntimeError, match="no search kernel"):
        auto_kernel._kernel_choice()


@pytest.mark.parametrize("kernel", ["triton", "tiles", "mxu"])
def test_kernel_env_override(monkeypatch, kernel):
    monkeypatch.setattr(S, "_KERNEL", kernel)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert S._kernel_choice() == kernel


def test_kernel_env_override_unknown_raises(monkeypatch):
    monkeypatch.setattr(S, "_KERNEL", "pallas")
    with pytest.raises(ValueError, match="NEEDLE_TPU_SEARCH"):
        S._kernel_choice()


def test_auto_fingerprint_backend_is_jax():
    from needle_tpu.analyzer import _fingerprint_backend

    assert _fingerprint_backend("auto") is _fingerprint_backend("jax")


def test_auto_fingerprint_backend_raises_instead_of_falling_back(monkeypatch):
    from needle_tpu.analyzer import _fingerprint_backend

    monkeypatch.setitem(sys.modules, "needle_tpu.fingerprint.jax_impl", None)
    with pytest.raises(ImportError):
        _fingerprint_backend("auto")


def test_auto_search_engine_is_jax():
    from needle_tpu import Comparator

    eng = Comparator.from_files(["a.mkv", "b.mkv"], engine="auto")._engine()
    assert isinstance(eng, S.JaxSearchEngine)


def test_auto_search_engine_raises_instead_of_falling_back(monkeypatch):
    from needle_tpu import Comparator, comparator

    def broken():
        raise RuntimeError("no device")

    monkeypatch.setattr(comparator, "_get_jax_engine", broken)
    cmp = Comparator.from_files(["a.mkv", "b.mkv"], engine="auto")
    with pytest.raises(RuntimeError, match="no device"):
        cmp._engine()


def test_unknown_search_engine_raises():
    from needle_tpu import Comparator

    with pytest.raises(ValueError, match="unknown search engine"):
        Comparator.from_files(["a.mkv"], engine="gpu")._engine()


@pytest.mark.parametrize("backend", ["auto", "jax"])
def test_pcm_sources_take_device_ingest(tmp_path, backend):
    from needle_tpu import Analyzer
    from needle_tpu.testing import make_synthetic_season

    paths, _, _ = make_synthetic_season(
        tmp_path, num_episodes=1, episode_secs=30, opening_secs=10, seed=3
    )
    an = Analyzer.from_files(paths, backend=backend)
    assert an._use_device_ingest(paths[0])
    assert not Analyzer.from_files(paths, backend="numpy")._use_device_ingest(
        paths[0]
    )


def _ensure_calls(monkeypatch):
    from needle_tpu import _jax_setup

    calls = {}
    monkeypatch.setattr(_jax_setup, "_initialized", False)
    monkeypatch.setattr(
        _jax_setup.jax.config, "update", lambda k, v: calls.__setitem__(k, v)
    )
    _jax_setup.ensure()
    return _jax_setup, calls


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    setup, calls = _ensure_calls(monkeypatch)
    assert calls["jax_compilation_cache_dir"] == str(setup.CACHE_DIR)
    assert setup.CACHE_DIR.name == ".jax_cache"
    assert setup.CACHE_DIR.parent == setup.Path(setup.__file__).parents[1]
    assert setup.cache_dir() == str(setup.CACHE_DIR)
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5


def test_compile_cache_env_sets_no_dir_in_code(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    setup, calls = _ensure_calls(monkeypatch)
    assert "jax_compilation_cache_dir" not in calls
    assert setup.cache_dir() == str(tmp_path)
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.5


@pytest.mark.parametrize(
    "kernel,n_pad,n_work,want",
    [
        ("triton", 2560, 10**6, 1024),  # full chunk
        ("triton", 2560, 378, 512),  # the season: next power of two
        ("tiles", 2560, 10**6, 102),  # the memory budget binds
        ("tiles", 512, 10**6, 128),  # the pair cap binds
        ("mxu", 512, 3, 4),
    ],
)
def test_chunk_size(kernel, n_pad, n_work, want):
    assert S._chunk_size(kernel, n_pad, n_work) == want


def test_tiles_and_mxu_are_separate_programs(rng):
    """The formulation is a static argument: `mxu` lowers to a matmul,
    `tiles` to none, and both flag the same diagonals."""
    import numpy as np

    n_pad = 256
    table = rng.integers(0, 2**32, size=(2, n_pad), dtype=np.uint32)
    table[1, 40:120] = table[0, 10:90]
    vtab = np.zeros((2, n_pad), bool)
    vtab[:, 1:] = True
    args = (table, vtab, np.array([0], np.int32), np.array([1], np.int32),
            np.array([20], np.int32), 10, n_pad)
    texts = {
        mxu: S._batch_tiles_indexed.lower(*args, mxu=mxu).as_text()
        for mxu in (False, True)
    }
    assert "dot_general" in texts[True]
    assert "dot_general" not in texts[False]
    out = [np.asarray(S._batch_tiles_indexed(*args, mxu=m)) for m in (0, 1)]
    np.testing.assert_array_equal(out[0], out[1])
    assert out[0].any()
