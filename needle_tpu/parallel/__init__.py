"""Multi-chip sharding over JAX device meshes.

The reference's parallelism is rayon thread pools over videos (analyze) and
over episode pairs (search) on one CPU (needle/src/audio/analyzer.rs:437-445,
comparator.rs:549-564). The device equivalents are mesh-sharded batch
axes with XLA inserting any collectives:

  * **episodes axis** — the fingerprint pipeline is batched over episodes
    (vmap); sharding the batch dimension over a 1-D mesh data-parallelizes
    analyze across cards. No cross-episode communication exists, so XLA
    emits zero collectives; results gather to host for persistence.
  * **pairs/tiles axis** — the search engine's (pair, diagonal-tile) work
    items are independent; sharding the item axis over the mesh
    data-parallelizes the all-pairs search. Hash tensors are small (u32 per
    ~0.25 s of audio), so full replication of inputs (an implicit
    all-gather) costs ~nothing next to the O(n*m) match work.

Use :func:`set_mesh` (or the `needle_mesh` context manager) to activate a
mesh; the JAX engines consult :func:`get_mesh` and shard their batched
dispatches automatically. On one device everything degrades to the
single-card path.

**Multi-host model (process-level sharding + per-process local meshes).**
Under `jax.distributed` the WORK LISTS are sharded across processes —
episodes for analyze, the pair list for search
(`parallel.distributed.local_shard` / `distributed_search`) — and each
process runs the JAX engines on its OWN addressable devices, optionally
mesh-sharded over a :func:`local_mesh`. Results are exchanged with
cross-process all-gathers and finalized identically everywhere. The
engines therefore never `device_put` to non-addressable devices: a mesh
passed to `shard_batch`/`replicate` must be built from local devices
(:func:`local_mesh` under multi-process; :func:`make_mesh` single-process,
where local == global). This fits the workload: episodes/pairs are
embarrassingly parallel, inputs are small, and no cross-pair communication
exists — a global-mesh formulation would buy nothing but the collective
overhead.

**Replication bound.** Each search process materializes the full episode
hash table to walk its pair shard: O(episodes × n_pad × 4 B) host + device
memory per process (1000 episodes × 2560 padded hashes ≈ 10 MB — far from
binding). Episode-count scaling hits the PAIR quadratic (O(n²) work,
sharded) long before the LINEAR table replication; if a library ever
outgrew device memory, the fix is partitioning the pair list into
episode-range tiles and loading per-tile tables, not sharding the table.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ITEM_AXIS = "items"

_active_mesh: Optional[Mesh] = None


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = ITEM_AXIS,
    allow_cpu_fallback: Optional[bool] = None,
) -> Mesh:
    """1-D mesh over the first `n_devices` devices (default: all).

    If the default platform has fewer devices than requested, the CPU
    platform (with --xla_force_host_platform_device_count=N) can stand in —
    but only with explicit opt-in, via `allow_cpu_fallback=True` or
    NEEDLE_TPU_CPU_MESH_FALLBACK=1. On a 1-card GPU host a silent fallback
    would quietly shard device-bound work onto host CPU devices; the default
    is to raise instead. When the default platform already IS cpu (tests,
    dryruns) no fallback is involved.
    """
    import os

    devices = jax.devices()
    if n_devices is not None and len(devices) < n_devices:
        if allow_cpu_fallback is None:
            allow_cpu_fallback = os.environ.get(
                "NEEDLE_TPU_CPU_MESH_FALLBACK", ""
            ) not in ("", "0")
        if allow_cpu_fallback:
            try:
                cpu = jax.devices("cpu")
            except RuntimeError:
                cpu = []
            if len(cpu) >= n_devices:
                import logging

                logging.getLogger("needle_tpu").warning(
                    "make_mesh: default platform %r has %d device(s) < %d; "
                    "falling back to a %d-device CPU mesh "
                    "(NEEDLE_TPU_CPU_MESH_FALLBACK)",
                    devices[0].platform if devices else "?",
                    len(devices), n_devices, n_devices,
                )
                devices = cpu
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def local_mesh(axis_name: str = ITEM_AXIS) -> Mesh:
    """1-D mesh over THIS process's addressable devices — the per-process
    mesh of the multi-host model (see module docstring). Single-process,
    this equals make_mesh()."""
    return Mesh(np.array(jax.local_devices()), (axis_name,))


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    _active_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _active_mesh


@contextlib.contextmanager
def needle_mesh(n_devices: Optional[int] = None):
    """Context manager activating a mesh for analyze/search dispatches."""
    mesh = make_mesh(n_devices)
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def replicate(array, mesh: Optional[Mesh] = None):
    """Place an array fully replicated over the active mesh (or on the
    default device with no mesh). Used for broadcast operands (e.g. the
    episode hash table) consumed by sharded batch dispatches."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None or np.prod(mesh.devices.shape) <= 1:
        return jax.device_put(array)
    sharding = NamedSharding(mesh, P(*([None] * np.ndim(array))))
    return jax.device_put(array, sharding)


def shard_batch(array, mesh: Optional[Mesh] = None, fill_value=0):
    """Place a batched array with its leading axis sharded over the mesh.

    Pads the leading axis to a multiple of the mesh size (with fill_value)
    and returns (device_array, original_leading_size). Callers slice
    outputs back to the original size; pick fill_value so padding lanes
    are cheap no-ops for the consuming kernel (e.g. an unreachable
    min-run length for search work items).
    """
    mesh = mesh if mesh is not None else get_mesh()
    b = array.shape[0]
    if mesh is None or np.prod(mesh.devices.shape) <= 1:
        return jax.numpy.asarray(array), b
    n_dev = int(np.prod(mesh.devices.shape))
    pad = (-b) % n_dev
    if pad:
        array = np.concatenate(
            [array, np.full((pad,) + array.shape[1:], fill_value, array.dtype)],
            axis=0,
        )
    axis = mesh.axis_names[0]
    sharding = NamedSharding(mesh, P(axis, *([None] * (array.ndim - 1))))
    return jax.device_put(array, sharding), b
