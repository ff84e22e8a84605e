"""Cross-episode search engines.

The reference searches for openings/endings with a per-pair O(n*m) dynamic
program on rayon CPU threads (needle/src/audio/comparator.rs:156-250). Here
the same semantics are provided by two engines:

  * :mod:`needle_tpu.search.oracle` — reference-exact NumPy implementation
    (validation oracle + small-input fallback), including emulation of the
    Rust BinaryHeap ordering that determines candidate iteration order.
  * :mod:`needle_tpu.search.jax_impl` — batched JAX engine: all pairs at
    once, each diagonal's runs found by a per-lane walk
    (:mod:`needle_tpu.search.triton_walk`, on the GPU) or by associative
    scans over skewed tiles (plain XLA, on the CPU and under device meshes).

Both produce identical `RunEntry` lists; host-side candidate voting lives in
:mod:`needle_tpu.comparator`.
"""

from .oracle import RunEntry, longest_common_hash_match, simhash32

__all__ = ["RunEntry", "longest_common_hash_match", "simhash32"]
