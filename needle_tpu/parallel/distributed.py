"""Multi-process / multi-host initialization for GPU hosts.

The reference has no distributed backend at all (single process + rayon;
SURVEY §5.8); scaling beyond one host here uses JAX's native runtime:
`jax.distributed.initialize` connects one process per host, after which
`jax.devices()` spans every card of every host. Each process owns all of
its host's cards through `local_mesh()`: the engines shard their batched
dispatches over those cards (XLA hands any collectives to NCCL over
NVLink), and the work lists are sharded across processes.

Typical multi-host launch (one process per host):

    import needle_tpu.parallel.distributed as dist
    dist.initialize("10.0.0.1:8476", num_processes=2, process_id=rank)
    needle_tpu.parallel.set_mesh(needle_tpu.parallel.local_mesh())
    dist.distributed_analyze(Analyzer.from_files(videos), hash_duration)
    dist.distributed_search(Comparator.from_files(videos), frame_hashes)

File IO remains per-host: each host analyzes the episodes it can see on
its filesystem (`.needle.dat` next to each video), and search results /
skip files are written by process 0 (`is_coordinator()`).
"""

from __future__ import annotations

from typing import Optional

import jax


_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Connect this process to the distributed runtime (idempotent).

    GPU hosts carry no cluster description JAX could discover, so pass
    the coordinator address, the process count and this process's id:
    initialize("10.0.0.1:8476", num_processes=4, process_id=0).
    """
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def is_coordinator() -> bool:
    """True on the process that should perform singleton side effects
    (result display, skip-file writes for shared filesystems)."""
    return jax.process_index() == 0


def process_count() -> int:
    return jax.process_count()


def local_shard(items):
    """Round-robin shard a list of work items (e.g. video paths) across
    processes — the episodes-axis analog of the reference's rayon fan-out,
    at the host level."""
    return list(items)[jax.process_index() :: jax.process_count()]


def barrier(name: str = "needle-barrier") -> None:
    """Cross-process synchronization point: a real collective over the
    global device set (no process proceeds until all reach it)."""
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def _allgather_bytes(payload: bytes):
    """All-gather one bytes blob per process. Returns the list of every
    process's blob, ordered by process index. Rides the same runtime
    collectives as device all-gathers (length exchange first, then a
    padded uint8 gather), so it needs no side-channel service."""
    import numpy as np
    from jax.experimental import multihost_utils

    arr = np.frombuffer(payload, dtype=np.uint8)
    lens = multihost_utils.process_allgather(
        np.array([arr.size], dtype=np.int64)
    ).reshape(-1)
    maxlen = max(1, int(lens.max()))
    buf = np.zeros(maxlen, np.uint8)
    buf[: arr.size] = arr
    gathered = multihost_utils.process_allgather(buf)
    return [
        gathered[p, : int(lens[p])].tobytes() for p in range(len(lens))
    ]


def distributed_analyze(analyzer, hash_duration, persist: bool = True):
    """Analyze this process's episode shard (round-robin over processes),
    then synchronize so every shard's `.needle.dat` files exist before
    anyone searches. Returns this process's local FrameHashes."""
    import copy

    sub = copy.copy(analyzer)
    sub.videos = local_shard(analyzer.videos)
    results = sub.run(hash_duration, persist=persist) if sub.videos else []
    barrier("needle-analyze-done")
    return results


def distributed_search(
    comparator,
    frame_hashes,
    display: bool = False,
    use_skip_files: bool = False,
    write_skip_files: bool = False,
):
    """All-pairs search with the PAIR LIST sharded across processes.

    Each process runs the comparator's engine (JAX engines included —
    their batched dispatches run on this process's local devices, sharded
    over a local mesh if one is active) on its shard of the reference's
    pair order; the per-pair infos are exchanged with a cross-process
    all-gather; every process then finalizes the identical union
    (deterministic voting), so all processes return the same results.
    Singleton side effects (display, skip-file writes) happen only on the
    coordinator."""
    import pickle

    n = len(comparator.videos)
    pairs = comparator.pair_order(n)
    mine = local_shard(pairs)
    infos = comparator.search_pair_infos(frame_hashes, mine)
    keep = [
        ((i, j), info)
        for (i, j), info in zip(mine, infos)
        if not info.is_empty()
    ]
    shards = _allgather_bytes(pickle.dumps(keep))
    merged = {}
    for blob in shards:
        for key, info in pickle.loads(blob):
            merged[key] = info
    data = [(i, j, merged[(i, j)]) for (i, j) in pairs if (i, j) in merged]
    lead = is_coordinator()
    return comparator.finalize_results(
        data,
        display=display and lead,
        use_skip_files=use_skip_files,
        write_skip_files=write_skip_files and lead,
    )
