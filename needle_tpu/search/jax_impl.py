"""Batched JAX/XLA search engine: all episode pairs at once on the device.

A reformulation of the reference's per-pair rayon DP loop
(needle/src/audio/comparator.rs:156-250, 549-564) for an accelerator.

Key ideas:

  * Skewed coordinates: matches form S[i, d] = popcount(src[i] ^ dst[j]) <= t
    with j = i + d - (n-1); a diagonal run of the (n x m) match matrix is a
    *vertical* run in (i, d). The reference's sequential LCS DP collapses to
    run-length-along-columns, which the `tiles` formulation computes with
    associative scans and the Triton walk (search/triton_walk.py) with a
    per-lane carry.
  * Work items are (pair, diagonal-tile): every item computes an
    (n_pad x D_TILE) tile, so one compiled shape serves any library size,
    memory stays bounded regardless of episode count, and the item axis is
    the natural axis to vmap/shard over device meshes.
  * Episode hashes live in a device-resident table uploaded once per
    search; pairs are (src, dst) index lists vmapped in fixed-size chunks,
    so transfers scale with episodes + pairs, not episodes x pairs.
  * The device reduces each pair to a u8 per-diagonal candidate-count
    vector (runs >= a conservative length bound, with the reference's
    row-0/column-0 zeroing applied exactly); the host rescans ONLY the
    flagged diagonals — O(n) each — to recover exact candidates, then the
    exact min-duration check, simhash, walk ordering, and Rust-BinaryHeap
    emulation run over that tiny set, so RunEntry lists are identical to
    the NumPy oracle with no O(n*m) fallback ever needed.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .._jax_setup import ensure as _jax_setup_ensure

_jax_setup_ensure()

from ..duration import Duration
from . import triton_walk as _triton_walk
from .geometry import D_TILE, full_block_mask, n_groups_for
from .oracle import RunEntry, binary_heap_order

# Per-dispatch device memory budget for the (n_pad x D_TILE) tiles. The
# value (and the 128-pair cap in _chunk_size) was tuned for the accelerator
# this code was first written for and is untuned on the H100.
_MEM_BUDGET = 6 << 30


def _popcount_u32_jnp(x: jnp.ndarray) -> jnp.ndarray:
    one = jnp.uint32(1)
    v = x - ((x >> one) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    v = (v + (v >> jnp.uint32(4))) & jnp.uint32(0x0F0F0F0F)
    return ((v * jnp.uint32(0x01010101)) >> jnp.uint32(24)).astype(jnp.int32)


def _tile_runs(src, dst, vsrc, vdst, l_min, d0, threshold, n_pad, m_pad):
    """One diagonal tile of one pair, at STATIC base offset d0.

    All index math uses compile-time constants — per-item traced offsets
    force XLA into a generic per-cell gather that measured ~27x slower.
    Validity is carried by uploaded bool arrays instead of traced lengths:
      vsrc[i]: i is a usable src index (i >= 1 and i < n_valid),
      vdst[j]: same for dst. Runs end wherever the NEXT cell is not a
      valid match — which already covers the last valid index of either
      side (the next cell fails the validity mask) and the physical tile
      edge (a zero row is appended), so no separate boundary tables are
      needed.

    Diagonals are indexed by the raw offset o = j - i; this tile covers
    o in [d0, d0 + D_TILE). Returns the per-diagonal count of run-end
    candidates with run >= l_min (a conservative hash-count bound for the
    min duration); the host rescans ONLY flagged diagonals — O(n) each —
    to extract exact candidates, so no information is lost to compaction
    and no O(n*m) fallback is ever needed.
    """
    i_idx = jax.lax.broadcasted_iota(jnp.int32, (n_pad, D_TILE), 0)
    o_idx = jax.lax.broadcasted_iota(jnp.int32, (n_pad, D_TILE), 1) + d0
    j_idx = jnp.clip(i_idx + o_idx, 0, m_pad - 1)
    oob = (i_idx + o_idx) != j_idx  # true where the clip actually clipped

    dstg = jnp.take(dst, j_idx, axis=0)
    vdstg = jnp.take(vdst, j_idx, axis=0) & ~oob

    S = (
        (_popcount_u32_jnp(src[:, None] ^ dstg) <= threshold)
        & vsrc[:, None]
        & vdstg
    )

    return _diag_end_counts(S, l_min)


def _diag_end_counts(S, l_min):
    """Per-diagonal count of run ends with run length >= l_min.

    run[i] >= L  <=>  the L cells ending at i are all matches
                 <=>  c[i] - c[i-L] == L   (c = cumsum of S along i)
    — one scan plus a traced-shift subtraction, instead of the cumsum +
    cummax run-length construction (the scans are the kernel's dominant
    cost; this halves them)."""
    n, d = S.shape
    c = jnp.cumsum(S.astype(jnp.int32), axis=0)
    cz = jnp.concatenate([jnp.zeros((n, d), jnp.int32), c], axis=0)
    l_min = jnp.clip(l_min, 1, n)
    shifted = jax.lax.dynamic_slice_in_dim(cz, n - l_min, n, axis=0)
    window_full = (c - shifted) == l_min
    S_next = jnp.concatenate([S[1:], jnp.zeros((1, d), bool)], axis=0)
    cand = S & ~S_next & window_full
    return jnp.sum(cand.astype(jnp.int32), axis=0)


def _pair_all_tiles(src, dst, vsrc, vdst, l_min, threshold, n_pad, m_pad):
    """All diagonal tiles of one pair, unrolled over a static d0 grid
    covering the full padded offset range [-(n_pad-1), m_pad-1].

    Returns a packed u8 BITMASK over diagonals (bit set = that diagonal has
    at least one candidate) — the host only needs "which diagonals to
    rescan", and the mask download is 8x smaller than byte counts, which
    matters at 10k+ pair library sizes.
    """
    counts = []
    d0 = -(n_pad - 1)
    while d0 <= m_pad - 1:
        c = _tile_runs(
            src, dst, vsrc, vdst, l_min, d0, threshold, n_pad, m_pad
        )
        counts.append(c)
        d0 += D_TILE
    flags = (jnp.concatenate(counts) > 0).reshape(-1, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, :]
    return jnp.sum(flags.astype(jnp.uint8) * weights, axis=1, dtype=jnp.uint8)


def _pair_counts_mxu(src, dst, vsrc, vdst, l_min, threshold, n_pad, m_pad):
    """Matmul formulation of one pair's per-diagonal candidate bitmask.

    popcount-as-matmul: with hash bits mapped to +-1, the dot product of two
    32-vectors is 32 - 2*hamming, so the full (n x m) match matrix is ONE
    bf16 matmul with f32 accumulation (exact: all values are integers within bf16's 8-bit
    mantissa range). Diagonals then become columns with NO gather via the
    pad+reshape skew: padding each row by (n_pad+1) columns and reshaping
    to a (n_pad, W+1) grid shifts row i right by i, so column d of the
    result is the diagonal at offset d - (n_pad-1). The run-length scans
    run per diagonal tile exactly as the `tiles` formulation's.
    """
    bit_w = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    src_pm1 = (
        ((src[:, None] & bit_w) != 0).astype(jnp.bfloat16) * 2.0 - 1.0
    )
    dst_pm1 = (
        ((dst[:, None] & bit_w) != 0).astype(jnp.bfloat16) * 2.0 - 1.0
    )
    M = jax.lax.dot_general(
        src_pm1, dst_pm1, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (n_pad, m_pad): 32 - 2*hamming
    S = (M >= jnp.float32(32 - 2 * threshold)) & vsrc[:, None] & vdst[None, :]

    # skew-by-reshape: S2[i, c] = S[i, i + c - (n_pad - 1)]
    n_diags = n_pad + m_pad - 1
    n_tiles = -(-n_diags // D_TILE)
    W2 = (n_pad - 1) + m_pad + (n_pad - 1) + 1  # left zeros + data + headroom
    S2 = jnp.pad(S, ((0, 0), (n_pad - 1, W2 - m_pad - (n_pad - 1))))
    flat = jnp.pad(S2.reshape(-1), (0, n_pad))
    G = flat[: n_pad * (W2 + 1)].reshape(n_pad, W2 + 1)
    G = jnp.pad(
        G[:, : n_diags], ((0, 0), (0, n_tiles * D_TILE - n_diags))
    )  # (n_pad, n_tiles*D_TILE), column d = diagonal offset d - (n_pad-1)

    counts = []
    for t in range(n_tiles):
        St = G[:, t * D_TILE : (t + 1) * D_TILE]
        counts.append(_diag_end_counts(St, l_min))
    flags = (jnp.concatenate(counts) > 0).reshape(-1, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, :]
    return jnp.sum(flags.astype(jnp.uint8) * weights, axis=1, dtype=jnp.uint8)


# Kernel formulation (NEEDLE_TPU_SEARCH):
#   "triton" — per-lane run walk, a Pallas kernel through Triton
#              (search/triton_walk.py): the GPU default.
#   "tiles"  — XLA gather-tile kernel: the CPU and mesh default (sharded
#              inputs would need shard_map around the Triton call).
#   "mxu"    — popcount-as-matmul + skew-by-reshape, plain XLA.
import os as _os

_KERNEL = _os.environ.get("NEEDLE_TPU_SEARCH", "auto")
_KERNELS = ("triton", "tiles", "mxu")


def _kernel_choice() -> str:
    if _KERNEL != "auto":
        if _KERNEL not in _KERNELS:
            raise ValueError(
                f"NEEDLE_TPU_SEARCH={_KERNEL!r}: expected auto or one of "
                f"{', '.join(_KERNELS)}"
            )
        return _KERNEL
    from ..parallel import get_mesh

    platform = jax.default_backend()
    if platform not in ("cpu", "gpu"):
        raise RuntimeError(f"no search kernel for platform {platform!r}")
    if platform == "cpu" or get_mesh() is not None:
        return "tiles"
    return "triton"


def _chunk_size(kernel, n_pad, n_work, mem_budget=_MEM_BUDGET) -> int:
    """Pairs per kernel dispatch. Small work lists round up to a power of
    two (tail chunks are padded to the same lane count), so the set of
    compiled programs stays small no matter the library size."""
    if kernel == "triton":
        # the walk keeps its state in registers; the only per-chunk device
        # memory is the gathered hash rows and one count row per pair, so
        # large chunks amortize dispatch overhead. 1024 was tuned for the
        # accelerator this code was first written for and is untuned on the
        # H100.
        chunk = 1024
    else:
        per_pair_bytes = n_pad * D_TILE * 12 * 4  # live tiles per pair
        chunk = max(1, min(128, mem_budget // max(per_pair_bytes, 1)))
    pow2 = 1
    while pow2 < n_work and pow2 < chunk:
        pow2 *= 2
    return min(chunk, pow2)


@functools.partial(
    jax.jit, static_argnames=("threshold", "n_pad", "interpret")
)
def _batch_walk_bitmask(
    table, vtab, ia_b, ib_b, lm_b, bm_b, threshold, n_pad, interpret=False
):
    """Triton-walk chunk dispatch producing the same packed u8 bitmask
    as the XLA kernels (episode rows gathered from the device table).
    `bm_b` is the band prefilter's per-(pair, group) row-block bitmask
    (all-ones = walk everything)."""
    from .triton_walk import batch_counts

    nv_tab = jnp.sum(vtab, axis=1, dtype=jnp.int32) + 1
    thr = jnp.full(ia_b.shape, threshold, jnp.int32)
    counts = batch_counts(
        nv_tab[ia_b], nv_tab[ib_b], lm_b, thr, table[ia_b], table[ib_b],
        n_pad, bm=bm_b, interpret=interpret,
    )
    flags = (counts > 0).reshape(counts.shape[0], -1, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))[None, None, :]
    return jnp.sum(flags.astype(jnp.uint8) * weights, axis=2, dtype=jnp.uint8)


@functools.partial(jax.jit, static_argnames=("threshold", "n_pad", "mxu"))
def _batch_tiles_indexed(
    table, vtab, ia_b, ib_b, lm_b, threshold, n_pad, mxu=False
):
    """Pairs gather their episodes from a device-resident hash table, so
    each episode's hashes are uploaded ONCE per search instead of once per
    pair — at 300 episodes that is a ~450x transfer reduction and removes
    the per-chunk host buffer assembly entirely. `mxu` selects the
    matmul formulation; it is a static argument so that each formulation
    gets its own compiled program."""
    pair_fn = _pair_counts_mxu if mxu else _pair_all_tiles

    def one(ia, ib, lm):
        return pair_fn(
            table[ia], table[ib], vtab[ia], vtab[ib],
            lm, threshold, n_pad, n_pad,
        )

    return jax.vmap(one)(ia_b, ib_b, lm_b)


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact_flags(out_u8, cap):
    """Flagged-diagonal compaction ON DEVICE: the packed count bitmask is
    ~640 B/pair (n_pad-dependent) and a dense 500k-pair scan would
    download ~320 MB of it, although only ~1-6 bits per pair are set.
    Returns (idx, total): flat bit positions of set bits (row-major over
    the chunk, identical order to the host unpack), -1-filled past
    `total`, plus the true count so the host can fall back to the full
    bitmask for pathological chunks (total > cap)."""
    bits = (out_u8[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    flat = bits.reshape(-1)
    total = jnp.sum(flat, dtype=jnp.int32)
    (idx,) = jnp.nonzero(flat, size=cap, fill_value=-1)
    return idx.astype(jnp.int32), total


def _compact_cap(chunk: int) -> int:
    """Index capacity per chunk: ~16 flagged diagonals per pair (dense
    synthetic libraries flag ~1/pair, the season ~4/pair), min 4096."""
    import os

    return int(
        os.environ.get("NEEDLE_TPU_COMPACT_CAP", str(max(4096, 16 * chunk)))
    )


# Max candidates extracted per flagged diagonal by the device pass; a
# diagonal with more run-ends (pathological self-similarity) falls back to
# the host rescan. Real flagged diagonals carry 1-2 ends.
K_CANDS = 8


@functools.partial(jax.jit, static_argnames=("threshold", "n_pad"))
def _batch_extract_candidates(
    table, vtab, tpad, ia_b, ib_b, off_b, lm_b, threshold, n_pad
):
    """Device extraction of run-end candidates for flagged diagonals.

    For each (pair, diagonal-offset) work item: recompute the diagonal's
    match vector from the device-resident episode table, run-length scan
    it, and return the top-K_CANDS run ends with run >= l_min as
    (end_i, run_len) plus the total count (count > K_CANDS => host
    fallback). Extracting only runs >= the conservative hash-count bound
    is exact: a shorter run spans < l_min * max_spacing <= min_duration
    of real time, so the later timestamp filter would drop it anyway.
    Replaces the host per-diagonal rescan that cost ~18% of wall at
    1000-episode scale (67 s of numpy over 500k diagonals).

    `tpad` is the zero-padded table (e_pad, 3*n_pad) built ONCE per side
    (see `_pad_tables`): a per-item `concatenate(zeros, hd, zeros)` would
    materialize (items, 3*n_pad) u32 + bool per chunk — ~4x the useful
    bytes. Validity is INDEX math, not memory: vtab
    rows are contiguous [1, nv) by construction (_search_side), so the
    per-item validity reads (a (items, n_pad) bool gather + a padded
    slice — ~20% of the stage's bytes) reduce to bounds checks against
    nv/mv scalars."""
    nv_tab = jnp.sum(vtab, axis=1, dtype=jnp.int32) + 1

    def one(ia, ib, off, lm):
        hs = table[ia]
        nv, mv = nv_tab[ia], nv_tab[ib]
        idx = jnp.arange(n_pad, dtype=jnp.int32)
        j = idx + off
        # The diagonal read hd[idx + off] is a SHIFTED SLICE, not a general
        # gather: dynamic_slice the pre-padded row at n_pad + off (start is
        # always in-bounds: off in [-(n_pad-1), n_pad-1]). Out-of-range j
        # is masked by the bounds check, matching zero-padded validity.
        hd_s = jax.lax.dynamic_slice(tpad, (ib, n_pad + off), (1, n_pad))[0]
        valid = (idx >= 1) & (idx < nv) & (j >= 1) & (j < mv)
        S = (_popcount_u32_jnp(hs ^ hd_s) <= threshold) & valid
        # Run length via ONE scan instead of two (cumsum + cummax of the
        # zeroed prefix): cummax over run-START positions gives, at every
        # cell, the start of the current run — run = idx - start + 1.
        # idx >= 1 wherever S holds (valid forces idx >= 1), so S[0] is
        # always False and the shifted start detection is safe.
        S_prev = jnp.concatenate([jnp.zeros(1, bool), S[:-1]])
        latest_start = jax.lax.cummax(
            jnp.where(S & ~S_prev, idx, jnp.int32(-1))
        )
        run = jnp.where(S, idx - latest_start + 1, 0)
        S_next = jnp.concatenate([S[1:], jnp.zeros(1, bool)])
        ends = S & ~S_next & (run >= jnp.maximum(lm, 1))
        score = jnp.where(ends, idx + 1, 0)
        top_vals = jax.lax.top_k(score, K_CANDS)[0]
        end_i = top_vals - 1  # -1 = unused slot
        runs = jnp.where(
            end_i >= 0, run[jnp.clip(end_i, 0, n_pad - 1)], 0
        )
        return end_i, runs, jnp.sum(ends.astype(jnp.int32))

    return jax.vmap(one)(ia_b, ib_b, off_b, lm_b)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _pad_tables(table, n_pad):
    """Zero-padded (e_pad, 3*n_pad) episode table for the extract
    kernel's shifted-slice reads — one device op per side (~30 MB at the
    1000-episode scale), replacing a per-item pad."""
    return jnp.pad(table, ((0, 0), (n_pad, n_pad)))


def _diag_candidates(
    hs: np.ndarray, hd: np.ndarray, off: int, threshold: int
) -> List[Tuple[int, int, int]]:
    """All run-end candidates (i, j, run_len) along one diagonal j = i + off.

    O(n) host rescan with semantics identical to the device kernel and the
    reference DP: indices start at 1 (the reference zeroes row/col 0 of its
    table, comparator.rs:179), a run ends where the next cell mismatches or
    either sequence ends. Min-duration filtering happens later against real
    timestamps (_entries_from_candidates), exactly as the reference does.
    """
    from .oracle import popcount_u32

    n, m = len(hs), len(hd)
    lo, hi = max(1, 1 - off), min(n, m - off)
    if hi <= lo:
        return []
    i = np.arange(lo, hi)
    match = popcount_u32(hs[i] ^ hd[i + off]) <= threshold
    if not match.any():
        return []
    c = np.cumsum(match)
    z = np.where(match, 0, c)
    run = c - np.maximum.accumulate(z)
    ends = match & np.append(~match[1:], True)
    pos = np.flatnonzero(ends)
    return [
        (int(i[p]), int(i[p] + off), int(run[p])) for p in pos
    ]


from .._shapes import size_bucket as _bucket  # noqa: E402  (shape buckets)


class _EpisodeSide:
    """Cached per-episode arrays for one segment type (opening/ending)."""

    __slots__ = ("hashes", "ts", "max_spacing", "_simhash_prefix")

    def __init__(self, hashes: np.ndarray, ts: np.ndarray):
        self.hashes = np.asarray(hashes, dtype=np.uint32)
        self.ts = np.asarray(ts, dtype=np.int64)
        self._simhash_prefix = None
        if len(ts) >= 2:
            # Clamp to >= 1: identical timestamps (corrupt or externally
            # produced .dat files) would otherwise divide-by-zero in the
            # min-run-length bound. A smaller-than-true spacing only
            # over-flags diagonals; the exact host filter stays correct.
            self.max_spacing = max(1, int(np.max(np.diff(self.ts))))
        else:
            self.max_spacing = 1

    @property
    def simhash_prefix(self) -> np.ndarray:
        """Per-bit prefix sums, computed once per episode (reused by every
        pair this episode participates in — at N episodes that is N-1
        pairs, so per-pair recompute dominated host time at scale)."""
        if self._simhash_prefix is None:
            from .oracle import simhash_prefix

            self._simhash_prefix = simhash_prefix(self.hashes)
        return self._simhash_prefix


def _heap_perm_segments(rank: np.ndarray, g0: np.ndarray, gb: np.ndarray) -> np.ndarray:
    """BinaryHeap backing-order permutation for every segment
    [g0[k], gb[k+1]) of `rank`, vectorized across same-size segments.

    `rank` must order identically to the entries' Ord keys (a dense rank —
    EQUAL keys must map to EQUAL ranks, since sift-up stops on <=). For
    each segment size the BinaryHeap push sequence is simulated across all
    segments of that size at once: the heap slot layout is identical, only
    the data-dependent sift swaps differ, and those vectorize as masked
    row updates. Segments of a rare size fall back to the scalar
    `binary_heap_perm`. Equivalence with the scalar spec is pinned by
    tests across sizes and tie patterns."""
    from .oracle import binary_heap_perm

    n_tot = len(rank)
    out = np.empty(n_tot, np.int64)
    sizes = (gb[1:] - g0).astype(np.int64)
    starts = g0.astype(np.int64)
    rank_l = None
    for n in np.unique(sizes):
        seg = np.flatnonzero(sizes == n)
        st = starts[seg]
        if n == 1:
            out[st] = st
            continue
        if n * len(seg) < 512:
            # scalar fallback: cheaper than numpy dispatch overhead for a
            # handful of tiny segments
            if rank_l is None:
                rank_l = rank.tolist()
            for s0 in st.tolist():
                s1 = s0 + int(n)
                p = binary_heap_perm(rank_l[s0:s1])
                out[s0:s1] = [s0 + q for q in p]
            continue
        m = len(seg)
        gather = st[:, None] + np.arange(n)[None, :]
        karr = rank[gather]  # (m, n) keys in push order
        data = np.zeros((m, n), np.int64)  # local index per heap slot
        kk = np.empty((m, n), np.int64)
        kk[:, 0] = karr[:, 0]
        rows_all = np.arange(m)
        for j in range(1, int(n)):
            pos = np.full(m, j, np.int64)
            key = karr[:, j]
            active = np.ones(m, bool)
            while True:
                parent = (pos - 1) >> 1
                pk = kk[rows_all, parent]
                swap = active & (key > pk)
                r = np.flatnonzero(swap)
                if len(r):
                    data[r, pos[r]] = data[r, parent[r]]
                    kk[r, pos[r]] = pk[r]
                pos = np.where(swap, parent, pos)
                active = swap & (pos > 0)
                if not active.any():
                    break
            data[rows_all, pos] = j
            kk[rows_all, pos] = key
        out[gather] = st[:, None] + data
    return out


class _LazyEntries:
    """Array-backed `List[RunEntry]` for one pair, in BinaryHeap backing
    order.

    A dense whole-library scan produces millions of entries; materializing
    RunEntry + 4 Duration objects for each costs microseconds per entry
    on the host, seconds over a dense 500k-pair scan — yet the only
    production consumer is `Comparator.find_best_match`, which needs just
    the simhash / run-duration COLUMNS for voting and the (run, hash
    duration) of the single winning candidate. This class keeps the
    columns as shared permuted arrays (`cols` is one tuple shared by every
    pair of a scan; this object holds only a [s0, s1) window) and
    materializes RunEntry objects lazily on first sequence-style access,
    so equivalence tests and any list-consuming caller see exactly the
    objects `_entries_from_candidates` would have built.

    cols layout: (L, ss, se, ds, de, ssim, dsim, sdur, ddur) — int64
    nanos / uint64 simhashes, already in heap order globally.
    """

    __slots__ = ("cols", "s0", "s1", "src_hd", "dst_hd", "is_opening", "_mat")

    def __init__(self, cols, s0, s1, src_hd, dst_hd, is_opening):
        self.cols = cols
        self.s0 = int(s0)
        self.s1 = int(s1)
        self.src_hd = src_hd
        self.dst_hd = dst_hd
        self.is_opening = is_opening
        self._mat = None

    # -- cheap protocol (no materialization) --------------------------------
    def __len__(self):
        return self.s1 - self.s0

    def vote_cols(self, is_source: bool):
        """(simhash, run-duration-nanos) column views for find_best_match's
        vote, for this pair viewed from the src or dst episode."""
        L, ss, se, ds, de, ssim, dsim, sdur, ddur = self.cols
        if is_source:
            return ssim[self.s0 : self.s1], sdur[self.s0 : self.s1]
        return dsim[self.s0 : self.s1], ddur[self.s0 : self.s1]

    def entry_run_hd(self, k: int, is_source: bool):
        """((run_start, run_end), hash_duration) of entry k — Durations
        constructed for this one entry only (the vote winner)."""
        L, ss, se, ds, de, ssim, dsim, sdur, ddur = self.cols
        g = self.s0 + k
        if is_source:
            a, b, hd = int(ss[g]), int(se[g]), self.src_hd
        else:
            a, b, hd = int(ds[g]), int(de[g]), self.dst_hd
        da = Duration.__new__(Duration)
        da._nanos = a
        db = Duration.__new__(Duration)
        db._nanos = b
        return (da, db), hd

    # -- list-compatible access (materializes) ------------------------------
    def materialize(self):
        if self._mat is None:
            L, ss, se, ds, de, ssim, dsim, _, _ = self.cols
            s0, s1 = self.s0, self.s1
            is_opening = self.is_opening
            not_opening = not is_opening
            src_hd, dst_hd = self.src_hd, self.dst_hd
            D_new = Duration.__new__
            out = []
            for k in range(s0, s1):
                d_ss = D_new(Duration)
                d_ss._nanos = int(ss[k])
                d_se = D_new(Duration)
                d_se._nanos = int(se[k])
                d_ds = D_new(Duration)
                d_ds._nanos = int(ds[k])
                d_de = D_new(Duration)
                d_de._nanos = int(de[k])
                out.append(
                    RunEntry(
                        int(L[k]),
                        (d_ss, d_se),
                        (d_ds, d_de),
                        int(ssim[k]),
                        int(dsim[k]),
                        is_opening,
                        not_opening,
                        is_opening,
                        not_opening,
                        src_hd,
                        dst_hd,
                    )
                )
            self._mat = out
        return self._mat

    def __getitem__(self, k):
        return self.materialize()[k]

    def __iter__(self):
        return iter(self.materialize())

    def __eq__(self, other):
        if isinstance(other, _LazyEntries):
            other = other.materialize()
        if isinstance(other, list):
            return self.materialize() == other
        return NotImplemented

    def __repr__(self):
        return f"_LazyEntries({self.materialize()!r})"

    def __reduce__(self):
        # Cross-process transport (parallel.distributed pickles infos):
        # arrive as the canonical plain list of RunEntry.
        return (list, (self.materialize(),))


class JaxSearchEngine:
    """Batched all-pairs search on the default JAX device."""

    def __init__(self, mem_budget: int = _MEM_BUDGET):
        self.mem_budget = mem_budget
        jax.devices()  # probe usability

    def _entries_from_candidates(
        self,
        side_s: _EpisodeSide,
        side_d: _EpisodeSide,
        cands: List[Tuple[int, int, int]],  # (i, j, run_len)
        src_hd: Duration,
        dst_hd: Duration,
        is_opening: bool,
        min_dur_ns: int,
    ) -> List[RunEntry]:
        if not cands:
            return []
        cands = sorted(cands, key=lambda t: (-t[0], -t[1]))  # reference walk order
        arr = np.array(cands, dtype=np.int64)
        i, j, L = arr[:, 0], arr[:, 1], arr[:, 2]
        ssi, dsi = i - L, j - L
        src_start, src_end = side_s.ts[ssi], side_s.ts[i]
        dst_start, dst_end = side_d.ts[dsi], side_d.ts[j]
        valid = ((src_end - src_start) >= min_dur_ns) & (
            (dst_end - dst_start) >= min_dur_ns
        )
        sel = np.flatnonzero(valid)
        if len(sel) == 0:
            return []
        from .oracle import simhash32_from_prefix

        src_sim = simhash32_from_prefix(side_s.simhash_prefix, ssi[sel], i[sel])
        dst_sim = simhash32_from_prefix(side_d.simhash_prefix, dsi[sel], j[sel])
        entries = [
            RunEntry(
                score=int(L[k]),
                src_longest_run=(
                    Duration.from_nanos(int(src_start[k])),
                    Duration.from_nanos(int(src_end[k])),
                ),
                dst_longest_run=(
                    Duration.from_nanos(int(dst_start[k])),
                    Duration.from_nanos(int(dst_end[k])),
                ),
                src_match_hash=int(src_sim[q]),
                dst_match_hash=int(dst_sim[q]),
                is_src_opening=is_opening,
                is_src_ending=not is_opening,
                is_dst_opening=is_opening,
                is_dst_ending=not is_opening,
                src_hash_duration=src_hd,
                dst_hash_duration=dst_hd,
            )
            for q, k in enumerate(sel)
        ]
        return binary_heap_order(entries)

    def _entries_batch(
        self, results, cand_row, cand_i, cand_j, cand_L,
        w_pidx, w_sa, w_sb, w_a, w_b, ep_ids, sides,
        hash_durations, is_opening, min_dur_ns, n_pad, e_pad,
    ) -> None:
        """Library-wide vectorization of `_entries_from_candidates` (the
        per-pair scalar spec, kept above as the readable reference — a
        regression test pins their equivalence). One lexsort establishes
        every pair's reference walk order, timestamp gathers and the
        min-duration filter run over a (e_pad, n_pad) ts table, simhashes
        batch per episode (prefix sums are per-episode anyway), and heap
        keys come from the arrays instead of per-entry ord_key() calls.
        A per-pair version costs tens of host microseconds per pair — tens
        of seconds at 500k dense pairs."""
        from .oracle import simhash32_from_prefix

        if len(cand_row) == 0:
            return
        # reference walk order within each pair: sorted by (-i, -j)
        order = np.lexsort((-cand_j, -cand_i, cand_row))
        row = cand_row[order]
        i = cand_i[order]
        j = cand_j[order]
        L = cand_L[order]
        ssi, dsi = i - L, j - L

        ts_tab = np.zeros((e_pad, n_pad), np.int64)
        for s, e in enumerate(ep_ids):
            t = sides[e].ts
            ts_tab[s, : len(t)] = t
        sa, sb = w_sa[row], w_sb[row]
        src_start, src_end = ts_tab[sa, ssi], ts_tab[sa, i]
        dst_start, dst_end = ts_tab[sb, dsi], ts_tab[sb, j]
        sel = np.flatnonzero(
            ((src_end - src_start) >= min_dur_ns)
            & ((dst_end - dst_start) >= min_dur_ns)
        )
        if len(sel) == 0:
            return
        row, i, j, L, ssi, dsi = (
            row[sel], i[sel], j[sel], L[sel], ssi[sel], dsi[sel]
        )
        src_start, src_end = src_start[sel], src_end[sel]
        dst_start, dst_end = dst_start[sel], dst_end[sel]
        sa, sb = sa[sel], sb[sel]

        # simhash per episode (not per pair): group the surviving
        # candidates by src/dst slot and evaluate each episode's prefix
        # sums once over all its ranges
        def sim_by_slot(slots, starts, ends):
            out = np.empty(len(slots), np.uint64)
            o2 = np.argsort(slots, kind="stable")
            sl = slots[o2]
            g0 = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1]])
            gb = np.r_[g0, len(sl)]
            for g in range(len(g0)):
                idx = o2[gb[g] : gb[g + 1]]
                prefix = sides[ep_ids[int(sl[gb[g]])]].simhash_prefix
                out[idx] = simhash32_from_prefix(prefix, starts[idx], ends[idx])
            return out

        src_sim = sim_by_slot(sa, ssi, i)
        dst_sim = sim_by_slot(sb, dsi, j)

        # RunEntry objects are NOT constructed here (microseconds per entry
        # even with inlined constructors, seconds over a dense 500k-pair
        # scan). The BinaryHeap backing order is a
        # pure function of the Ord keys, so compute the per-pair heap
        # PERMUTATION on key tuples, apply it to the columns once
        # library-wide, and hand each pair a _LazyEntries window that
        # materializes objects only if something list-walks it (the
        # production consumer, find_best_match, reads the columns).
        # per-pair groups (row is sorted ascending)
        g0 = np.flatnonzero(np.r_[True, row[1:] != row[:-1]])
        gb = np.r_[g0, len(row)]
        # Dense rank replacing the Ord-key tuples: one lexsort orders the
        # 7-column key prefix (the dropped suffix — flags, hash durations —
        # is constant within one pair's heap, so it can never change a
        # comparison), adjacent-distinct cumsum assigns EQUAL keys EQUAL
        # ranks (sift-up stops on <=, so ties are semantic), and the heap
        # simulation then compares single ints instead of 7-tuples.
        key_cols = (L, src_start, src_end, dst_start, dst_end, src_sim, dst_sim)
        o = np.lexsort(key_cols[::-1])
        neq = np.zeros(len(o), bool)
        for c in key_cols:
            cs = c[o]
            neq[1:] |= cs[1:] != cs[:-1]
        rank = np.empty(len(o), np.int64)
        rank[o] = np.cumsum(neq)
        pa = _heap_perm_segments(rank, g0, gb)
        src_start, src_end = src_start[pa], src_end[pa]
        dst_start, dst_end = dst_start[pa], dst_end[pa]
        cols = (
            L[pa],
            src_start,
            src_end,
            dst_start,
            dst_end,
            src_sim[pa],
            dst_sim[pa],
            src_end - src_start,
            dst_end - dst_start,
        )
        rows_first = row[g0]
        pidx_l = w_pidx[rows_first].tolist()
        ha_l = w_a[rows_first].tolist()
        hb_l = w_b[rows_first].tolist()
        s0_l = gb[:-1].tolist()
        s1_l = gb[1:].tolist()
        for pidx, ai, bi, s0, s1 in zip(pidx_l, ha_l, hb_l, s0_l, s1_l):
            results[pidx] = _LazyEntries(
                cols, s0, s1, hash_durations[ai], hash_durations[bi], is_opening
            )

    def _search_side(
        self,
        comparator,
        sides: List[_EpisodeSide],
        hash_durations: List[Duration],
        pairs: List[Tuple[int, int]],
        is_opening: bool,
    ) -> Dict[int, List[RunEntry]]:
        threshold = int(comparator.hash_match_threshold)
        min_dur = (
            comparator.min_opening_duration
            if is_opening
            else comparator.min_ending_duration
        )
        min_dur_ns = min_dur.total_nanos()

        results: Dict[int, List[RunEntry]] = {p: [] for p in range(len(pairs))}
        work = []
        for p_idx, (a, b) in enumerate(pairs):
            if len(sides[a].hashes) == 0 or len(sides[b].hashes) == 0:
                continue
            work.append((p_idx, a, b))
        if not work:
            return results

        kernel = _kernel_choice()
        n_pad = _bucket(
            max(
                max(len(sides[a].hashes) for _, a, _ in work),
                max(len(sides[b].hashes) for _, _, b in work),
            )
        )
        m_pad = n_pad

        # Per-pair device work; validity/boundary carried by bool arrays so
        # every traced value in the kernel's index math is a constant.
        chunk = _chunk_size(kernel, n_pad, len(work), self.mem_budget)
        # flagged-diagonal compaction cap (0 = disabled, full-bitmask d2h)
        compact_cap = (
            _compact_cap(chunk)
            if _os.environ.get("NEEDLE_TPU_COMPACT_FLAGS", "1") != "0"
            else 0
        )
        cap = compact_cap

        pair_lm: Dict[int, int] = {}
        d_base = -(n_pad - 1)

        # Launch every chunk asynchronously (JAX queues dispatches), then
        # collect — hides upload/dispatch latency behind device compute.
        from ..parallel import shard_batch
        from ..tracing import span

        launched = []
        launch_span = span(
            "search.launch",
            side="opening" if is_opening else "ending",
            work=len(work),
            chunk=chunk,
            n_pad=n_pad,
        )
        launch_span.__enter__()

        # Episode hash table: every episode referenced by any pair, uploaded
        # ONCE. The episode axis is bucketed so the compiled program count
        # stays bounded as the library grows.
        ep_ids = sorted({a for _, a, _ in work} | {b for _, _, b in work})
        ep_slot = {e: s for s, e in enumerate(ep_ids)}
        e_pad = _bucket(len(ep_ids))
        table = np.zeros((e_pad, n_pad), np.uint32)
        vtab = np.zeros((e_pad, n_pad), bool)
        for e, s in ep_slot.items():
            h = sides[e].hashes
            nv = len(h)
            table[s, :nv] = h
            # index 0 is never usable (the reference zeroes row/col 0)
            vtab[s, 1:nv] = True
        from ..parallel import replicate

        table_d = replicate(table)
        vtab_d = replicate(vtab)

        # l_min per pair (cells): conservative run-length bound from the
        # min duration and each side's max hash spacing — used by the
        # kernels, and its minimum over the work list sizes the pair
        # prefilter's block width. Array math over the work list (the
        # per-pair Python loop was ~1 s at 500k pairs).
        # pre-prefilter arrays: valid ONLY against this work list (the
        # prefilter compacts `work` below; everything consumed after it is
        # rebuilt as w_* from the kept list)
        pre_a = np.fromiter((a for _, a, _ in work), np.int64, len(work))
        pre_b = np.fromiter((b for _, _, b in work), np.int64, len(work))
        ceil_ep = np.ones(len(sides), np.int64)
        for e in ep_ids:
            ceil_ep[e] = -(-min_dur_ns // sides[e].max_spacing)
        lm_w = np.minimum(
            np.maximum(ceil_ep[pre_a], ceil_ep[pre_b]),
            np.iinfo(np.int32).max,
        )
        pair_lm = dict(zip((p for p, _, _ in work), lm_w.tolist()))

        # Exact matmul pair prefilter. For the Triton walk the band variant
        # additionally returns per-(pair, group) row-block bitmasks that
        # localize the walk to the diagonal bands where a qualifying run
        # can live — dense same-show pairs then walk only the run's
        # neighborhood instead of every (row, diagonal) cell. Other
        # kernels keep the pair-level skip (with its dense probe). Results
        # for skipped pairs stay [].
        from ..tracing import metrics as _pf_metrics
        from .prefilter import (
            direct_diag_items,
            prefilter_band_masks,
            prefilter_pairs,
        )

        # Direct diagonal flagging: a qualifying prefilter cell
        # C[b, t] >= bound pins the single diagonal d = t - bW, and every
        # qualifying run contains an aligned W-block, so the flagged
        # diagonal set is a sound SUPERSET of what the count kernels
        # flag — extraction (exact per-pair l_min scan) runs on it
        # directly and the entire count-kernel walk is skipped. Applies
        # to every kernel; see prefilter._tile_diag_flags for the
        # exactness argument and the dense-in-episode-space gate.
        band_masks = None
        n_groups = 0
        n_skipped = 0
        with span("search.prefilter", work=len(work)):
            direct_items = direct_diag_items(
                table_d, vtab_d, work, ep_slot,
                lambda p: pair_lm[p], threshold, n_pad,
            )
        if direct_items is not None:
            _pf_metrics.record(
                "search.direct_items", float(len(direct_items[0]))
            )
        with span("search.prefilter", work=len(work)):
            if direct_items is not None:
                pass  # flags already resolved; no walk to prefilter
            elif kernel == "triton":
                n_groups = n_groups_for(n_pad)
                work, band_masks, n_skipped, _pf_w = prefilter_band_masks(
                    table_d, vtab_d, work, ep_slot,
                    lambda p: pair_lm[p], threshold, n_pad,
                )
                if band_masks is None:
                    # band masks inapplicable (e.g. n_blocks > 31 on very
                    # long buckets, where a 31-bit i32 mask can't cover
                    # the blocks) — keep at least the pair-level skip.
                    # prefilter_pairs re-checks the plan, so when the
                    # prefilter is off entirely this is a cheap no-op.
                    work, n_skipped, _pf_w = prefilter_pairs(
                        table_d, vtab_d, work, ep_slot,
                        lambda p: pair_lm[p], threshold, n_pad,
                    )
            else:
                work, n_skipped, _pf_w = prefilter_pairs(
                    table_d, vtab_d, work, ep_slot,
                    lambda p: pair_lm[p], threshold, n_pad,
                )
        if n_skipped:
            _pf_metrics.record("search.prefilter_skipped", float(n_skipped))

        # Struct-of-arrays view of the (post-prefilter) work list: the
        # launch fill, the bit-unpack, and the extract batch build are all
        # array gathers over these instead of per-item Python loops (the
        # tuple-at-a-time versions cost ~9 s unpack + a comparable share of
        # extract at 500k dense pairs).
        n_work = len(work)
        w_pidx = np.fromiter((p for p, _, _ in work), np.int64, n_work)
        w_a = np.fromiter((a for _, a, _ in work), np.int64, n_work)
        w_b = np.fromiter((b for _, _, b in work), np.int64, n_work)
        w_sa = np.fromiter((ep_slot[a] for _, a, _ in work), np.int32, n_work)
        w_sb = np.fromiter((ep_slot[b] for _, _, b in work), np.int32, n_work)
        w_lm = np.fromiter((pair_lm[p] for p, _, _ in work), np.int32, n_work)

        # direct mode resolved the flagged diagonals already: launch no
        # count-kernel chunks (the collect plumbing below handles the
        # empty launch list and item_rows/item_offs come from the flags)
        chunk_starts = (
            range(0, len(work), chunk) if direct_items is None else range(0)
        )
        for c0 in chunk_starts:
            batch = work[c0 : c0 + chunk]
            # Padding lanes point at episode slot 0 with an unreachable
            # min-run, so they can never produce candidates.
            ia_b = np.zeros((chunk,), np.int32)
            ib_b = np.zeros((chunk,), np.int32)
            lm_b = np.full((chunk,), np.iinfo(np.int32).max, np.int32)
            ia_b[: len(batch)] = w_sa[c0 : c0 + len(batch)]
            ib_b[: len(batch)] = w_sb[c0 : c0 + len(batch)]
            lm_b[: len(batch)] = w_lm[c0 : c0 + len(batch)]

            if kernel == "triton":
                # padding lanes get mask 0: they walk NOTHING
                bm_b = np.zeros((chunk, n_groups), np.int32)
                if band_masks is None:
                    bm_b[: len(batch)] = full_block_mask(n_pad)
                else:
                    bm_b[: len(batch)] = band_masks[c0 : c0 + len(batch)]
                out = _batch_walk_bitmask(
                    table_d,
                    vtab_d,
                    shard_batch(ia_b)[0],
                    shard_batch(ib_b)[0],
                    shard_batch(lm_b, fill_value=np.iinfo(np.int32).max)[0],
                    shard_batch(bm_b)[0],
                    threshold,
                    n_pad,
                    interpret=_triton_walk.INTERPRET,
                )
            else:
                out = _batch_tiles_indexed(
                    table_d,
                    vtab_d,
                    shard_batch(ia_b)[0],
                    shard_batch(ib_b)[0],
                    # padding lanes get an unreachable min-run so mesh
                    # padding cannot create expensive self-match work
                    shard_batch(lm_b, fill_value=np.iinfo(np.int32).max)[0],
                    threshold,
                    n_pad,
                    mxu=kernel == "mxu",
                )
            # flagged-diagonal compaction: the (chunk, nbytes) bitmask is
            # ~640 B/pair but carries ~1-6 set bits per pair; downloading
            # flat bit INDICES instead shrinks the dense scan's d2h from
            # ~320 MB to ~30 MB
            compacted = (
                _compact_flags(out, cap) if compact_cap else None
            )
            launched.append((c0, len(batch), out, compacted))

        launch_span.__exit__(None, None, None)

        collect_span = span(
            "search.collect", side="opening" if is_opening else "ending"
        )
        collect_span.__enter__()
        # Coalesce chunk outputs and download them in one transfer per
        # group of chunks, so each download pays the per-transfer fixed
        # cost once per group instead of once per chunk.
        import time as _time

        from ..tracing import metrics as _metrics

        group = int(_os.environ.get("NEEDLE_TPU_COLLECT_GROUP", "64"))
        _t0 = _time.perf_counter()
        if compact_cap:
            # download (idx, total) per chunk, coalesced per group
            idx_tot = []
            for g0 in range(0, len(launched), group):
                _tg = _time.perf_counter()
                idx_tot.extend(
                    jax.device_get(
                        [ct for _, _, _, ct in launched[g0 : g0 + group]]
                    )
                )
                _metrics.record(
                    "search.collect_device_group",
                    _time.perf_counter() - _tg,
                )
            counts_all = None
        else:
            parts = []
            for g0 in range(0, len(launched), group):
                outs = [o for _, _, o, _ in launched[g0 : g0 + group]]
                _tg = _time.perf_counter()
                parts.append(
                    np.asarray(
                        jnp.concatenate(outs) if len(outs) > 1 else outs[0]
                    )
                )
                _metrics.record(
                    "search.collect_device_group", _time.perf_counter() - _tg
                )
            if parts:
                counts_all = (
                    np.concatenate(parts) if len(parts) > 1 else parts[0]
                )
            else:  # every pair prefilter-skipped: nothing was launched
                counts_all = np.zeros((0, 1), np.uint8)
        _metrics.record(
            "search.collect_device", _time.perf_counter() - _t0
        )  # device execute + concat + d2h of the coalesced flags
        _t0 = _time.perf_counter()
        row0 = 0
        n_overflow = 0
        rows_parts: List[np.ndarray] = []  # global work-row index per item
        offs_parts: List[np.ndarray] = []  # diagonal offset per item

        def unpack_bitmask(a8, c0):
            # Sparse bit expansion: nonzero BYTES first, then expand only
            # those. unpackbits materialized the full (chunk, n_diag) bit
            # matrix — ~2.6 GB of host traffic and ~12 s at 500k dense
            # pairs vs ~2 s this way (identical row-major item order).
            rb, cb = np.nonzero(a8)
            v = a8[rb, cb]
            bitmat = (v[:, None] >> np.arange(8, dtype=np.uint8)) & 1
            sub_r, sub_k = np.nonzero(bitmat)
            rows_parts.append(rb[sub_r].astype(np.int64) + c0)
            offs_parts.append(
                (cb[sub_r].astype(np.int64) * 8 + sub_k) + d_base
            )

        for k, (c0, n_batch, out, _ct) in enumerate(launched):
            if compact_cap:
                idx, total = idx_tot[k]
                if int(total) > len(idx):
                    # pathological chunk: more flags than the index cap —
                    # fall back to this chunk's full bitmask (rare; the
                    # device ref is still alive)
                    n_overflow += 1
                    unpack_bitmask(np.asarray(out)[:n_batch], c0)
                    continue
                idx = idx[: int(total)].astype(np.int64)
                n_bits_row = out.shape[1] * 8
                rows = idx // n_bits_row
                # padded lanes (shard_batch) produce no flags; rows are
                # guaranteed < n_batch by the padding lm/mask guards
                rows_parts.append(rows + c0)
                offs_parts.append((idx % n_bits_row) + d_base)
            else:
                # out.shape[0] can exceed `chunk` when shard_batch padded
                # the lane axis to the mesh device count; advance by the
                # REAL row count or every later chunk reads misaligned rows.
                counts = counts_all[row0 : row0 + out.shape[0]]
                row0 += out.shape[0]
                unpack_bitmask(counts[:n_batch], c0)
        if n_overflow:
            _metrics.record(
                "search.collect_compact_overflow", float(n_overflow)
            )
        item_rows = (
            np.concatenate(rows_parts) if rows_parts else np.zeros(0, np.int64)
        )
        item_offs = (
            np.concatenate(offs_parts) if offs_parts else np.zeros(0, np.int64)
        )
        if direct_items is not None:
            item_rows, item_offs = direct_items
        _metrics.record("search.collect_unpack", _time.perf_counter() - _t0)
        cand_row, cand_i, cand_j, cand_L = self._extract_candidates(
            item_rows, item_offs, work, w_sa, w_sb, w_lm,
            sides, table_d, vtab_d, threshold, n_pad,
        )
        collect_span.__exit__(None, None, None)

        with span("search.entries", cands=len(cand_row)):
            self._entries_batch(
                results, cand_row, cand_i, cand_j, cand_L,
                w_pidx, w_sa, w_sb, w_a, w_b, ep_ids, sides,
                hash_durations, is_opening, min_dur_ns, n_pad, e_pad,
            )
        return results

    def _extract_candidates(
        self, item_rows, item_offs, work, w_sa, w_sb, w_lm,
        sides, table_d, vtab_d, threshold, n_pad,
    ):
        """Turn flagged (pair, diagonal) work items into exact (i, j, run)
        candidates: a batched device pass returns the top-K_CANDS run ends
        per diagonal; overflowing diagonals (count > K_CANDS) rescan on
        host. NEEDLE_TPU_EXTRACT=host forces the all-host path.

        Items arrive and candidates leave as parallel arrays — returns
        (cand_row, cand_i, cand_j, cand_L) int64 arrays where cand_row
        indexes `work`. Tuple-at-a-time plumbing costs seconds of host
        time at 500k dense pairs; _entries_batch consumes the arrays
        without ever materializing per-pair candidate lists.
        """
        import os
        import time as _time

        from ..tracing import metrics as _metrics

        empty = np.zeros(0, np.int64)
        n_items = len(item_rows)
        if n_items == 0:
            return empty, empty, empty, empty
        host_only = (
            os.environ.get("NEEDLE_TPU_EXTRACT") == "host"
            or jax.default_backend() == "cpu" and n_items < 64
        )
        t0 = _time.perf_counter()
        host_diags = 0
        row_parts, i_parts, j_parts, L_parts = [], [], [], []

        def host_diag(row: int, off: int) -> None:
            _, a, b = work[row]
            cands = _diag_candidates(
                sides[a].hashes, sides[b].hashes, off, threshold
            )
            if cands:
                arr = np.asarray(cands, np.int64)
                row_parts.append(np.full(len(arr), row, np.int64))
                i_parts.append(arr[:, 0])
                j_parts.append(arr[:, 1])
                L_parts.append(arr[:, 2])

        if host_only:
            for row, off in zip(item_rows.tolist(), item_offs.tolist()):
                host_diag(row, off)
            host_diags = n_items
        else:
            tpad_d = _pad_tables(table_d, n_pad)
            CH = 4096
            launched = []
            for c0 in range(0, n_items, CH):
                rows_blk = item_rows[c0 : c0 + CH]
                offs_blk = item_offs[c0 : c0 + CH]
                n_blk = _bucket(len(rows_blk), minimum=min(CH, 256))
                ia = np.zeros(n_blk, np.int32)
                ib = np.zeros(n_blk, np.int32)
                off_a = np.zeros(n_blk, np.int32)
                lm_a = np.full(n_blk, np.iinfo(np.int32).max, np.int32)
                ia[: len(rows_blk)] = w_sa[rows_blk]
                ib[: len(rows_blk)] = w_sb[rows_blk]
                off_a[: len(rows_blk)] = offs_blk
                lm_a[: len(rows_blk)] = w_lm[rows_blk]
                launched.append(
                    (
                        rows_blk,
                        offs_blk,
                        _batch_extract_candidates(
                            table_d, vtab_d, tpad_d,
                            jnp.asarray(ia), jnp.asarray(ib),
                            jnp.asarray(off_a), jnp.asarray(lm_a),
                            threshold, n_pad,
                        ),
                    )
                )
            # ONE coalesced device_get for every chunk's triple instead of
            # a synchronous round trip per array per chunk (3 arrays x 122
            # chunks at the dense-1000 shape).
            got = jax.device_get([t[2] for t in launched])
            for (rows_blk, offs_blk, _), (end_i, runs, counts) in zip(
                launched, got
            ):
                end_i = end_i[: len(rows_blk)]
                runs = runs[: len(rows_blk)]
                counts = counts[: len(rows_blk)]
                # pathological diagonals (count > K): exact host extraction
                for r in np.flatnonzero(counts > K_CANDS):
                    host_diag(int(rows_blk[r]), int(offs_blk[r]))
                    host_diags += 1
                # vectorized unpack of the filled slots (a python loop over
                # every K slot of every item cost ~30 s at 500k diagonals)
                rs, ks = np.nonzero(
                    (end_i >= 0) & (counts <= K_CANDS)[:, None]
                )
                ei = end_i[rs, ks].astype(np.int64)
                row_parts.append(rows_blk[rs])
                i_parts.append(ei)
                j_parts.append(ei + offs_blk[rs])
                L_parts.append(runs[rs, ks].astype(np.int64))
        if row_parts:
            out = (
                np.concatenate(row_parts),
                np.concatenate(i_parts),
                np.concatenate(j_parts),
                np.concatenate(L_parts),
            )
        else:
            out = (empty, empty, empty, empty)
        _metrics.record("search.extract", _time.perf_counter() - t0)
        _metrics.record("search.extract_diags", float(n_items))
        if host_diags:
            _metrics.record("search.extract_host_fallback", float(host_diags))
        return out

    def search_pairs(self, comparator, frame_hashes, pairs, threading=True):
        """Engine entry point used by Comparator.run_with_frame_hashes.

        `threading` is accepted for engine-interface parity; the device
        batch path is already parallel across pairs (the flag governs the
        CPU fallback engine)."""
        from ..comparator import OpeningAndEndingInfo
        from ..errors import FrameHashDataNoEnding

        hash_durations = [fh.hash_duration() for fh in frame_hashes]

        # Validate ending data BEFORE any device work: raising after the
        # all-pairs opening search would waste minutes of dispatches on
        # large libraries.
        if comparator.include_endings:
            for a, b in pairs:
                if (
                    len(frame_hashes[a].ending_hashes) == 0
                    or len(frame_hashes[b].ending_hashes) == 0
                ):
                    raise FrameHashDataNoEnding()

        open_sides = [
            _EpisodeSide(fh.opening_hashes, fh.opening_ts_nanos) for fh in frame_hashes
        ]
        open_entries = self._search_side(
            comparator, open_sides, hash_durations, pairs, True
        )

        end_entries: Dict[int, List[RunEntry]] = {}
        if comparator.include_endings:
            end_sides = [
                _EpisodeSide(fh.ending_hashes, fh.ending_ts_nanos)
                for fh in frame_hashes
            ]
            end_entries = self._search_side(
                comparator, end_sides, hash_durations, pairs, False
            )

        # This engine's entries carry uniform flags per side (openings are
        # all is_*_opening, endings all is_*_ending — _entries_batch), so
        # the reference's per-entry flag regrouping (comparator.rs:290-303,
        # mirrored in Comparator._find_opening_and_ending_with) reduces to
        # placing each side's whole list in both src and dst slots.
        empty: List[RunEntry] = []
        infos = []
        for p_idx in range(len(pairs)):
            op = open_entries.get(p_idx, empty)
            en = (
                end_entries.get(p_idx, empty)
                if comparator.include_endings
                else empty
            )
            # Entry lists are placed (not copied) into both src and dst
            # slots: nothing downstream mutates them, and copying a
            # _LazyEntries through list() would defeat its laziness.
            infos.append(OpeningAndEndingInfo(op, op, en, en))
        return infos
