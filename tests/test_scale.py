"""Large-library scale paths: episode-table bucketing, chunked pair search,
streaming analyze waves, process-level sharding helpers."""

import numpy as np
import pytest

from needle_tpu.data import FrameHashes
from needle_tpu.duration import Duration


def _mk_frame_hashes(rng, n_eps, n_hashes=300, shared=None, shared_at=None):
    """Synthetic FrameHashes; optionally splice a shared hash run."""
    out = []
    step = 247619033  # ~0.248 s in ns, matching hash_duration 0.3 stepping
    for e in range(n_eps):
        h = rng.integers(0, 2**32, size=n_hashes, dtype=np.uint32)
        if shared is not None:
            at = shared_at[e]
            h[at : at + len(shared)] = shared
        ts = (2600090703 + np.arange(n_hashes) * step).astype(np.int64)
        out.append(
            FrameHashes(
                h, ts, np.zeros(0, np.uint32), np.zeros(0, np.int64),
                Duration.from_millis(300), f"{e:032x}",
            )
        )
    return out


def test_search_100_episodes_finds_shared_run(rng):
    """100 episodes -> 4950 pairs through the chunked device path; every
    episode shares one 80-hash run (~20 s) at varying offsets."""
    from needle_tpu import Comparator

    n_eps = 100
    shared = rng.integers(0, 2**32, size=80, dtype=np.uint32)
    shared_at = [10 + (e % 7) * 20 for e in range(n_eps)]
    fhs = _mk_frame_hashes(rng, n_eps, shared=shared, shared_at=shared_at)
    cmp = Comparator.from_files(
        [f"ep{k:03}.mkv" for k in range(n_eps)], engine="jax"
    ).with_min_opening_duration(Duration.from_secs(15))
    results = cmp.run_with_frame_hashes(
        fhs, display=False, use_skip_files=False, write_skip_files=False
    )
    found = sum(1 for r in results if r.opening is not None)
    assert found == n_eps, f"only {found}/{n_eps} episodes matched"


def test_search_no_false_positives_at_scale(rng):
    """Unrelated random hash streams must not match (5050-pair smoke)."""
    from needle_tpu import Comparator

    fhs = _mk_frame_hashes(rng, 40, n_hashes=200)
    cmp = Comparator.from_files([f"e{k}.mkv" for k in range(40)], engine="jax")
    results = cmp.run_with_frame_hashes(
        fhs, display=False, use_skip_files=False, write_skip_files=False
    )
    assert all(r.opening is None for r in results)


def test_streaming_analyze_waves(tmp_path, monkeypatch):
    """More episodes than STREAM_BLOCK processes in multiple bounded waves."""
    from needle_tpu import Analyzer
    from needle_tpu.testing import make_synthetic_season

    make_synthetic_season(
        tmp_path, num_episodes=5, episode_secs=30, opening_secs=8, seed=55
    )
    paths = sorted(tmp_path.glob("*.wav"))
    monkeypatch.setattr(Analyzer, "STREAM_BLOCK", 2)  # force 3 waves
    fhs = Analyzer.from_files(paths, backend="jax").run(
        Duration.from_secs_f32(np.float32(0.3)), persist=False
    )
    assert len(fhs) == 5
    assert all(len(f.opening_hashes) > 0 for f in fhs)


def test_local_shard_partitions_completely():
    from needle_tpu.parallel import distributed as dist

    items = [f"ep{k}" for k in range(11)]
    # single-process: everything lands on this process
    assert dist.local_shard(items) == items
    assert dist.is_coordinator()


def test_mesh_with_padded_chunks_matches_oracle(rng):
    """Chunks smaller than the mesh device count get their lane axis padded
    by shard_batch; collection must advance by the REAL device row count or
    every chunk after the first reads misaligned bitmask rows (regression)."""
    from needle_tpu import Comparator
    from needle_tpu.parallel import needle_mesh
    from needle_tpu.search.jax_impl import JaxSearchEngine

    shared = rng.integers(0, 2**32, size=60, dtype=np.uint32)
    fhs = _mk_frame_hashes(
        rng, 6, n_hashes=240, shared=shared, shared_at=[10 + 9 * e for e in range(6)]
    )

    def run(engine_name, mesh, mem_budget=None):
        cmp = Comparator.from_files(
            [f"m{k}.mkv" for k in range(6)], engine=engine_name
        ).with_min_opening_duration(Duration.from_secs(10))
        if engine_name == "jax" and mem_budget is not None:
            cmp._engine_obj = JaxSearchEngine(mem_budget=mem_budget)
            cmp._engine = lambda: cmp._engine_obj  # force tiny chunks
        if mesh:
            from needle_tpu.parallel import needle_mesh as nm

            with nm(8):
                res = cmp.run_with_frame_hashes(
                    fhs, display=False, use_skip_files=False,
                    write_skip_files=False,
                )
        else:
            res = cmp.run_with_frame_hashes(
                fhs, display=False, use_skip_files=False, write_skip_files=False
            )
        return [(r.opening, r.ending) for r in res]

    # tiny budget -> chunk of ~2-4 lanes -> multiple chunks, each padded to 8
    expected = run("numpy", mesh=False)
    got = run("jax", mesh=True, mem_budget=2 * 256 * 512 * 12 * 4)
    assert got == expected
    assert any(op is not None for op, _ in expected)


def test_make_mesh_cpu_fallback_requires_opt_in(monkeypatch, caplog):
    """make_mesh must not silently shard onto CPU devices when the default
    platform has too few devices: explicit opt-in (arg or env) is required,
    and the fallback logs a warning."""
    import logging

    import jax

    from needle_tpu import parallel

    n = len(jax.devices())
    # plenty of devices: no fallback involved either way
    assert parallel.make_mesh(n) is not None

    class _FakeDev:
        platform = "gpu"

    real_devices = jax.devices

    def fake_devices(plat=None):
        if plat is None:
            return [_FakeDev()]  # 1-card default platform
        return real_devices(plat)

    monkeypatch.setattr(jax, "devices", fake_devices)
    monkeypatch.delenv("NEEDLE_TPU_CPU_MESH_FALLBACK", raising=False)
    with pytest.raises(RuntimeError):
        parallel.make_mesh(8)

    # explicit opt-in allows the fallback and logs it
    with caplog.at_level(logging.WARNING, logger="needle_tpu"):
        mesh = parallel.make_mesh(8, allow_cpu_fallback=True)
    assert int(np.prod(mesh.devices.shape)) == 8
    assert any("falling back" in r.message for r in caplog.records)

    # env-driven opt-in
    monkeypatch.setenv("NEEDLE_TPU_CPU_MESH_FALLBACK", "1")
    mesh = parallel.make_mesh(8)
    assert int(np.prod(mesh.devices.shape)) == 8
