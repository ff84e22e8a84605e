"""Multi-host execution proof: 2 real processes over jax.distributed,
running the JAX ENGINES (not the numpy fallbacks) end to end.

The reference is single-process (SURVEY §5.8); needle-tpu's multi-host
model is process-level work sharding + per-process local meshes
(parallel/__init__.py docstring): each process analyzes its episode shard
with backend="jax" over a 2-device local mesh (`local_mesh`), a collective
barrier synchronizes the `.needle.dat` files, then BOTH processes search
their shard of the pair list with engine="jax" and exchange per-pair infos
through a cross-process all-gather (`distributed_search`), finalizing
identical results everywhere. This test launches two actual CPU processes
wired through `jax.distributed.initialize` and runs that exact flow.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

_WORKER = r"""
import json
import os
import sys

# Pin CPU before any jax backend init, so no worker opens a GPU; 2 virtual
# devices per process so the per-process local mesh is a real (2-device)
# mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"  # 2 virtual devices/process
sys.path.insert(0, sys.argv[1])

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from needle_tpu import Analyzer, Comparator
from needle_tpu.data import FrameHashes, frame_hash_data_path
from needle_tpu.duration import Duration
from needle_tpu.parallel import local_mesh, set_mesh
import needle_tpu.parallel.distributed as dist

coord, pid, season = sys.argv[2], int(sys.argv[3]), sys.argv[4]
nproc = int(sys.argv[5])

dist.initialize(coordinator_address=coord, num_processes=nproc, process_id=pid)
assert dist.is_initialized()
assert dist.process_count() == nproc, dist.process_count()
assert jax.process_index() == pid
assert len(jax.devices()) == nproc * len(jax.local_devices())

# per-process local mesh: the JAX engines shard their batched dispatches
# over THIS process's 2 addressable devices
mesh = local_mesh()
assert mesh.devices.size == 2
set_mesh(mesh)

from pathlib import Path

paths = sorted(Path(season).glob("*.wav"))

hd = Duration.from_secs_f32(np.float32(0.3))
analyzer = Analyzer.from_files(paths, backend="jax")
local_fh = dist.distributed_analyze(analyzer, hd, persist=True)
assert 0 < len(local_fh) < len(paths)  # both processes got work

# every process loads the union (persisted .dat files on the shared fs)
fhs = [FrameHashes.from_path(frame_hash_data_path(p)) for p in paths]

# pair-sharded search with the JAX engine; infos all-gather across the
# 2 processes; identical finalize everywhere
cmp = Comparator.from_files(paths, engine="jax")
results = dist.distributed_search(
    cmp, fhs, display=False, use_skip_files=False, write_skip_files=True,
)
out = [
    None
    if r.opening is None
    else [r.opening[0].as_secs_f64(), r.opening[1].as_secs_f64()]
    for r in results
]
Path(season, f"RESULTS_{pid}.json").write_text(json.dumps(out))
print(f"process {pid}: OK")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2, 4])
def test_multi_process_distributed_analyze_search(tmp_path, nproc):
    """2 processes = the standard leg; 4 processes proves the
    shard/all-gather logic has no pairwise-only assumptions
    (episode shards of 1, uneven pair shards 2/2/1/1)."""
    from needle_tpu.testing import make_synthetic_season

    season = tmp_path / "season"
    # opening must exceed the default 20 s minimum (comparator defaults)
    make_synthetic_season(
        season, num_episodes=4, episode_secs=90, opening_secs=25, seed=13
    )

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"127.0.0.1:{_free_port()}"

    env = dict(os.environ)
    # hermetic: CPU only, no inherited platform/device forcing
    env["PYTHONPATH"] = str(REPO)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [
                sys.executable, str(worker), str(REPO), coord, str(pid),
                str(season), str(nproc),
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420 + 120 * nproc)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"process {pid}: OK" in out

    # every shard analyzed (4 .dat files across the processes)
    assert len(list(season.glob("*.needle.dat"))) == 4
    # ALL processes finalized the union of the pair shards, identically
    rs = [
        json.loads((season / f"RESULTS_{pid}.json").read_text())
        for pid in range(nproc)
    ]
    assert all(r == rs[0] for r in rs[1:])
    assert len(rs[0]) == 4
    assert any(r is not None for r in rs[0])
    # skip files written once, by the coordinator only
    assert len(list(season.glob("*.needle.skip.json"))) >= 1
