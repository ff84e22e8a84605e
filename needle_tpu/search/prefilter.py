"""Exact matmul pair prefilter: skip whole pairs that provably have no run.

The diagonal-run kernels walk every (i, diagonal) cell of every pair. For
libraries that mix shows (the realistic whole-library scan the reference
supports via its all-pairs Comparator, comparator.rs:156-250), most pairs
share NOTHING, yet the walk still pays full price for them. This module
computes, per pair, a *sound* upper-bound test as bf16 matrix products
(tensor-core work with f32 accumulation) and skips the walk entirely for
pairs that cannot contain a qualifying run. Exactness is preserved by construction: the
test only ever skips pairs for which NO run of length >= l_min exists,
so the surviving pairs produce byte-identical RunEntry lists.

## The bound

A candidate needs a run of L >= l_min consecutive diagonal cells
(i, j=i+d) with popcount(src[i] ^ dst[j]) <= thr. Map each 32-bit hash
to its +/-1 bit vector; then

    dot(src[i], dst[j]) = 32 - 2 * popcount(src[i] ^ dst[j]) >= 32 - 2*thr

for every cell of the run. Any interval of L >= 2W - 1 consecutive rows
contains a block of W rows starting at a multiple of W, so a qualifying
run (with W <= (l_min + 1) // 2) contains an aligned all-matching block:
W consecutive cells (bW + u, t + u), u in [0, W), whose summed dot

    C[b, t] = sum_u dot(src[bW + u], dst[t + u]) >= W * (32 - 2*thr).

Therefore  max_{b,t} C[b,t] < W * (32 - 2*thr)  proves no run of length
>= l_min exists anywhere in the pair — on any diagonal, at any position
— and the pair can be skipped. Unrelated episode hashes have zero-mean
dots (sigma = sqrt(32 * W) per block sum, ~32 for W=32, vs a bound of
384 at the default thr=10), so in mixed libraries nearly every
unrelated pair is skipped while every related pair is kept.

## Computing max C with matrix products, exactly

C[b, t] is a blocked cross-correlation. Decompose t = W*q + r: for each
residue r, shift dst by r rows and block BOTH sides into rows of W*32,

    F[b]    = src_pm[b*W : (b+1)*W, :]    flattened   (n/W, W*32)
    G_r[q]  = dst_pm[r + q*W : r + (q+1)*W, :] flat   (n/W, W*32)
    C[b, W*q + r] = <F[b], G_r[q]>  =  (F @ G_r^T)[b, q],

i.e. W small matmuls per pair, batched over the pair chunk. All inputs are +/-1 (exact in bfloat16) and every partial sum is
an integer of magnitude <= 32 * n_pad < 2^24, so bf16 x bf16 -> f32
accumulation computes C EXACTLY — the comparison against the bound uses
a 0.5 slack purely against representation pedantry, never needed.

Rows outside [1, nv) (reference zeroes row/col 0; tails are padding) are
zeroed in the +/-1 expansion: a qualifying run only occupies valid rows
on both sides, so zeroing never deflates its block sum; it only tightens
the bound for noise.

## When it runs

Auto-enabled for large pair counts (the season's 378 pairs aren't worth
the extra compiled programs) when W >= 8 and thr < 16; see
`prefilter_plan`. NEEDLE_TPU_SEARCH_PREFILTER=on/off/auto overrides.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

# the walk kernel's geometry: masks MUST match it bit-for-bit, so derive
# every block/group constant from geometry instead of restating it
from .geometry import D_TILE, GROUP_DIAGS, n_groups_for, n_row_blocks


def prefilter_plan(n_work: int, min_lm: int, threshold: int, n_pad: int):
    """Decide whether to prefilter and with what block width W.

    Returns W (power of two, 8..64) or None. Sound for every pair whose
    l_min >= min_lm (W <= (min_lm + 1) // 2 guarantees an aligned
    W-block inside any qualifying run)."""
    mode = os.environ.get("NEEDLE_TPU_SEARCH_PREFILTER", "auto")
    if mode == "off":
        return None
    if threshold >= 16:  # bound W*(32-2*thr) <= 0: test can never skip
        return None
    w = 8
    while w * 2 <= 64 and w * 2 <= (min_lm + 1) // 2 and n_pad % (w * 2) == 0:
        w *= 2
    if w > (min_lm + 1) // 2 or n_pad % w != 0:
        return None
    if mode != "on" and n_work < 2048:
        # small libraries: the walk is already sub-second; extra compiled
        # programs and the mask roundtrip aren't worth it
        return None
    return w


@functools.partial(jax.jit, static_argnames=("w", "threshold", "n_pad"))
def _chunk_max_corr(exp_tab, ia_b, ib_b, w, threshold, n_pad):
    """Max blocked cross-correlation per pair lane.

    exp_tab: (e_pad, n_pad, 32) bf16 +/-1 (invalid rows zeroed);
    returns (chunk,) f32 of max_{b,t} C[b,t] (see module docstring)."""
    S = exp_tab[ia_b]  # (chunk, n, 32)
    T = exp_tab[ib_b]
    chunk = S.shape[0]
    nb = n_pad // w
    F = S.reshape(chunk, nb, w * 32)
    Tpad = jnp.pad(T, ((0, 0), (0, w), (0, 0)))

    def step(best, r):
        Tr = jax.lax.dynamic_slice_in_dim(Tpad, r, n_pad, axis=1)
        G = Tr.reshape(chunk, nb, w * 32)
        C = jnp.einsum(
            "cbf,cqf->cbq", F, G, preferred_element_type=jnp.float32
        )
        return jnp.maximum(best, C.max(axis=(1, 2))), None

    best0 = jnp.full((chunk,), -jnp.inf, jnp.float32)
    best, _ = jax.lax.scan(step, best0, jnp.arange(w))
    return best


@functools.partial(jax.jit, static_argnames=("n_pad",))
def expand_pm1(table, vtab, n_pad):
    """u32 hash table -> (e_pad, n_pad, 32) bf16 in {-1, 0, +1}.

    Bit c of hash h maps to +1 if set else -1; rows with vtab False
    (row 0, tails past nv) are zeroed."""
    bits = (table[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & jnp.uint32(1)
    pm = bits.astype(jnp.bfloat16) * 2 - 1
    return pm * vtab[..., None].astype(jnp.bfloat16)


def keep_bound(w: int, threshold: int) -> float:
    return w * (32 - 2 * threshold) - 0.5


def _member_matrix(w: int, n_pad: int, n_blocks: int) -> np.ndarray:
    """Static (nb, n_blocks) membership: kernel row blocks intersected by
    the qualifying-run margin [bW - W + 1, bW + 2W) of src block b
    (<= 2 blocks: 3W - 1 <= 191 < D_TILE; block B covers rows
    [B*D_TILE - 1, (B+1)*D_TILE - 1), see geometry)."""
    nb = n_pad // w
    b_arr = np.arange(nb, dtype=np.int64)
    blo = np.clip((b_arr * w - w + 2) // D_TILE, 0, n_blocks - 1)
    bhi = np.clip((b_arr * w + 2 * w) // D_TILE, 0, n_blocks - 1)
    member = np.zeros((nb, n_blocks), np.int32)
    member[b_arr, blo] = 1
    member[b_arr, bhi] = 1
    return member


@functools.partial(
    jax.jit,
    static_argnames=("w", "threshold", "n_pad", "gd", "n_groups", "n_blocks"),
)
def _chunk_band_masks(
    exp_tab, ia_b, ib_b, w, threshold, n_pad, gd, n_groups, n_blocks
):
    """Band-resolved version of `_chunk_max_corr`, reduced all the way to
    the walk kernel's per-(pair, group) row-block bitmasks ON DEVICE.

    Per (pair, src block b, diagonal group g) the scan marks whether ANY
    qualifying cell C[b, t] >= bound exists with t - b*w in group g's
    diagonal span (g = (d + n_pad - 1) // gd, the walk kernel's group
    index) — same matmuls as `_chunk_max_corr` plus a cheap masked
    any-reduction per group. The epilogue then folds b down to the kernel
    row blocks its qualifying-run margin [bW - W + 1, bW + 2W) can touch
    (a static (nb, n_blocks) membership built at trace time) and packs
    the result as (chunk, n_groups) int32 bitmasks, so the host only ever
    downloads 2 KB per chunk instead of the (chunk, nb, n_groups) bool
    tensor."""
    S = exp_tab[ia_b]  # (chunk, n, 32)
    T = exp_tab[ib_b]
    chunk = S.shape[0]
    nb = n_pad // w
    F = S.reshape(chunk, nb, w * 32)
    Tpad = jnp.pad(T, ((0, 0), (0, w), (0, 0)))
    bound = keep_bound(w, threshold)
    bq = jnp.arange(nb, dtype=jnp.int32)
    dq = bq[None, :] - bq[:, None]  # (b, q): q - b

    def step(acc, r):
        Tr = jax.lax.dynamic_slice_in_dim(Tpad, r, n_pad, axis=1)
        G = Tr.reshape(chunk, nb, w * 32)
        C = jnp.einsum(
            "cbf,cqf->cbq", F, G, preferred_element_type=jnp.float32
        )
        Q = C >= bound  # (chunk, nb, nb); cell (b, q) is t = w*q + r
        g_map = (w * dq + r + (n_pad - 1)) // gd  # diagonal d = t - b*w
        per_g = [
            jnp.any(Q & (g_map == g)[None], axis=2) for g in range(n_groups)
        ]
        return jnp.logical_or(acc, jnp.stack(per_g, axis=-1)), None

    acc0 = jnp.zeros((chunk, nb, n_groups), bool)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(w))
    member = _member_matrix(w, n_pad, n_blocks)
    hit = (
        jnp.einsum("cbg,bk->ckg", acc.astype(jnp.int32), jnp.asarray(member))
        > 0
    )  # (chunk, n_blocks, n_groups)
    bits = jnp.int32(1) << jnp.arange(n_blocks, dtype=jnp.int32)
    # distinct bits per block k, so sum over k == bitwise OR
    return jnp.sum(
        jnp.where(hit, bits[None, :, None], jnp.int32(0)),
        axis=1,
        dtype=jnp.int32,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "w", "threshold", "n_pad", "gd", "n_groups", "n_blocks", "ta", "tb"
    ),
)
def _tile_band_masks(
    exp_tab, a0, b0, w, threshold, n_pad, gd, n_groups, n_blocks, ta, tb
):
    """Episode-factorized band masks: one (ta, tb) episode-tile rectangle
    of the pair space per dispatch.

    `_chunk_band_masks` gathers a (chunk, n_pad, 32) operand PER PAIR.
    But every pair draws from the same
    episode table, so the +/-1 block features are pair-INDEPENDENT: this
    kernel slices two episode TILES once and correlates all ta*tb pair
    combinations as one (ta*nb, w*32) x (w*32, tb*nb) matmul per
    residue — no per-pair operands at all. Identical integer dots,
    identical bound comparison, identical member fold => masks
    bit-identical to the per-pair path (regression-tested)."""
    A = jax.lax.dynamic_slice_in_dim(exp_tab, a0, ta, axis=0)
    B = jax.lax.dynamic_slice_in_dim(exp_tab, b0, tb, axis=0)
    nb = n_pad // w
    F = A.reshape(ta, nb, w * 32)
    Bpad = jnp.pad(B, ((0, 0), (0, w), (0, 0)))
    bound = keep_bound(w, threshold)
    bq = jnp.arange(nb, dtype=jnp.int32)
    dq = bq[None, :] - bq[:, None]  # (n, q): q - n

    def step(acc, r):
        Br = jax.lax.dynamic_slice_in_dim(Bpad, r, n_pad, axis=1)
        G = Br.reshape(tb, nb, w * 32)
        C = jnp.einsum(
            "anf,bqf->abnq", F, G, preferred_element_type=jnp.float32
        )
        Q = C >= bound  # (ta, tb, nb, nb); cell (n, q) is t = w*q + r
        g_map = (w * dq + r + (n_pad - 1)) // gd  # diagonal d = t - n*w
        per_g = [
            jnp.any(Q & (g_map == g)[None, None], axis=3)
            for g in range(n_groups)
        ]
        return jnp.logical_or(acc, jnp.stack(per_g, axis=-1)), None

    acc0 = jnp.zeros((ta, tb, nb, n_groups), bool)
    acc, _ = jax.lax.scan(step, acc0, jnp.arange(w))
    member = _member_matrix(w, n_pad, n_blocks)
    hit = (
        jnp.einsum(
            "abng,nk->abkg", acc.astype(jnp.int32), jnp.asarray(member)
        )
        > 0
    )  # (ta, tb, n_blocks, n_groups)
    bits = jnp.int32(1) << jnp.arange(n_blocks, dtype=jnp.int32)
    return jnp.sum(
        jnp.where(hit, bits[None, None, :, None], jnp.int32(0)),
        axis=2,
        dtype=jnp.int32,
    )


def _dense_tile_plan(sa, sb, e_pad):
    """Tile assignment for the episode-factorized path. Tiles of the
    episode-slot axis may OVERLAP at the tail (starts are clamped to
    e_pad - tile), so this plan is the single source of truth for both
    dispatch and host assembly: it returns, per needed tile, the clamped
    origins plus the work-row permutation (`order`) and tile boundaries
    (`bounds`, len(uniq)+1 entries) that map work rows to tiles —
    consumers must not re-derive any of these. The tile sizes 16 and 128
    were tuned for the accelerator this code was first written for and are
    untuned on the H100."""
    ta_sz = int(os.environ.get("NEEDLE_TPU_PREFILTER_TA", "16"))
    tb_sz = int(os.environ.get("NEEDLE_TPU_PREFILTER_TB", "128"))
    ta_sz = max(1, min(ta_sz, e_pad))
    tb_sz = max(1, min(tb_sz, e_pad))
    nta = -(-e_pad // ta_sz)
    ntb = -(-e_pad // tb_sz)
    tia = np.minimum(sa // ta_sz, nta - 1)
    tib = np.minimum(sb // tb_sz, ntb - 1)
    key = tia.astype(np.int64) * ntb + tib
    uniq = np.unique(key)
    order = np.argsort(key, kind="stable")
    bounds = np.append(np.searchsorted(key[order], uniq), len(order))
    origins = []
    for k in uniq:
        ti, tj = divmod(int(k), ntb)
        origins.append(
            (min(ti * ta_sz, e_pad - ta_sz), min(tj * tb_sz, e_pad - tb_sz))
        )
    return ta_sz, tb_sz, uniq, order, bounds, origins


def _band_masks_dense(
    exp, sa, sb, w, threshold, n_pad, gd, n_groups, n_blocks, plan
):
    """Dispatch the needed episode-tile rectangles and assemble the
    per-work-pair masks on host (one coalesced device_get)."""
    ta_sz, tb_sz, uniq, order, bounds, origins = plan
    outs = [
        _tile_band_masks(
            exp, np.int32(a0), np.int32(b0), w, threshold, n_pad,
            gd, n_groups, n_blocks, ta_sz, tb_sz,
        )
        for a0, b0 in origins
    ]
    outs = jax.device_get(outs)
    masks = np.empty((len(sa), n_groups), np.int32)
    for t, (out, (a0, b0)) in enumerate(zip(outs, origins)):
        idx = order[bounds[t] : bounds[t + 1]]
        masks[idx] = out[sa[idx] - a0, sb[idx] - b0]
    return masks


@functools.partial(
    jax.jit,
    static_argnames=("w", "threshold", "n_pad", "ta", "tb", "cap"),
)
def _tile_diag_flags(exp_tab, a0, b0, mask, w, threshold, n_pad, ta, tb, cap):
    """Direct diagonal flagging for one episode-tile rectangle.

    KEY IDENTITY: a qualifying cell
    C[b, t] >= bound is an aligned all-matching W-block of cells
    (bW + u, t + u), which all lie on the SINGLE diagonal d = t - bW.
    Since every qualifying run (length >= l_min >= 2W - 1, guaranteed by
    prefilter_plan) CONTAINS an aligned W-block, the set
    {d : exists b with C[b, bW + d] >= bound} is a SUPERSET of the
    diagonals the count kernel flags — so the entire count-kernel walk
    (the dense scan's dominant stage) is information-redundant whenever
    the plan applies: extraction (exact by construction) can run on
    these candidate diagonals directly. False positives (a matching
    block without an l_min run) merely extract to nothing.

    Returns (widx, wvals, total): the nonzero u32 WORDS of the flat
    (ta*tb * 2*n_pad)-bit flag matrix — bit = d + n_pad - 1 within a
    pair's row, identical to the count-kernel bitmask convention —
    widx -1-filled past `total` (host re-dispatches with a bigger cap on
    overflow) and wvals the packed 32-bit word at each index. `mask`
    (ta, tb) bool keeps only cells that are real work pairs (kills
    self-pair and non-work noise on diagonal tiles).

    Derivation of the bit position: with K = (q - b) + (nb - 1) the
    anti-diagonal index and t = wq + r, d = w(q - b) + r, so
    bit = d + n_pad - 1 = wK + r + (w - 1) — the flattened (K, r) array
    shifted by w - 1."""
    A = jax.lax.dynamic_slice_in_dim(exp_tab, a0, ta, axis=0)
    B = jax.lax.dynamic_slice_in_dim(exp_tab, b0, tb, axis=0)
    nb = n_pad // w
    n_bits = 2 * n_pad
    F = A.reshape(ta, nb, w * 32)
    Bpad = jnp.pad(B, ((0, 0), (0, w), (0, 0)))
    bound = keep_bound(w, threshold)
    # static anti-diagonal one-hot: M[n*nb + q, (q - n) + nb - 1] = 1 —
    # sum over an anti-diagonal as one matmul (a per-(n,q) gather or
    # 159-way select would scalarize; counts <= nb so f32 accum is exact)
    M = np.zeros((nb * nb, 2 * nb - 1), np.float32)
    nn, qq = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    M[(nn * nb + qq).ravel(), (qq - nn + nb - 1).ravel()] = 1.0
    M = jnp.asarray(M.astype(jnp.bfloat16))

    def step(carry, r):
        Br = jax.lax.dynamic_slice_in_dim(Bpad, r, n_pad, axis=1)
        G = Br.reshape(tb, nb, w * 32)
        C = jnp.einsum(
            "anf,bqf->abnq", F, G, preferred_element_type=jnp.float32
        )
        Q = (C >= bound).astype(jnp.bfloat16).reshape(ta, tb, nb * nb)
        D = jnp.einsum("abx,xk->abk", Q, M, preferred_element_type=jnp.float32)
        return carry, D > 0.5  # (ta, tb, 2nb-1)

    _, ys = jax.lax.scan(step, None, jnp.arange(w))
    ys = ys & mask[None, :, :, None]
    yt = jnp.moveaxis(ys, 0, -1)  # (ta, tb, 2nb-1, w): flat pos = wK + r
    flat_kr = yt.reshape(ta, tb, (2 * nb - 1) * w)
    bits = jnp.pad(
        flat_kr,
        ((0, 0), (0, 0), (w - 1, n_bits - (2 * nb - 1) * w - (w - 1))),
    )
    # Two-level compaction: jnp.nonzero over the raw (ta*tb*n_bits) bool
    # (10.5M elements at the dense-1000 tile shape) would cost far more
    # than the matmuls. Bit-PACK to u32 words first (n_bits is a multiple of 32:
    # every bucket is a multiple of 32 rows and n_bits = 2*n_pad), then
    # nonzero over the 32x smaller word array; the host expands set words
    # exactly like the count-kernel bitmask unpack.
    words = jnp.sum(
        bits.reshape(-1, 32).astype(jnp.uint32)
        << jnp.arange(32, dtype=jnp.uint32),
        axis=1,
        dtype=jnp.uint32,
    )
    nz = words != jnp.uint32(0)
    total = jnp.sum(nz, dtype=jnp.int32)
    (widx,) = jnp.nonzero(nz, size=cap, fill_value=-1)
    wvals = words[jnp.clip(widx, 0, words.shape[0] - 1)]
    return widx.astype(jnp.int32), wvals, total


def _initial_cap(seg_max: int, ta_sz: int, tb_sz: int) -> int:
    """Initial flag-word cap for `_tile_diag_flags`: 2 words per work
    cell of the densest tile, pow2-bucketed, floor 1024, clamped to the
    tile-area bound (8 * ta * tb)."""
    return min(
        max(1024, 1 << (max(1, 2 * seg_max) - 1).bit_length()),
        8 * ta_sz * tb_sz,
    )


def direct_diag_items(
    table_d, vtab_d, work, ep_slot, lm_of, threshold, n_pad
):
    """Candidate (work row, diagonal offset) items straight from the
    matmul block correlation — replacing the count-kernel walk entirely (see
    `_tile_diag_flags`). Returns (item_rows, item_offs) int64 arrays in
    the exact format `_extract_candidates` consumes, or None when direct
    flagging doesn't apply (mode off / plan inapplicable / work list too
    sparse in episode-pair space for the tile rectangles).

    Exactness: the flagged set is a superset of the count kernel's
    qualifying diagonals for every pair (module docstring bound +
    l_min >= 2W - 1 from prefilter_plan); extraction applies each pair's
    own l_min exactly, so extra flags only cost extract work. Pairs with
    no flags produce no items — identical to the band prefilter's
    all-zero-mask drop."""
    mode = os.environ.get("NEEDLE_TPU_SEARCH_DIRECT", "auto")
    if mode == "off" or not work:
        return None
    min_lm = min(lm_of(p) for p, _, _ in work)
    w = prefilter_plan(len(work), min_lm, threshold, n_pad)
    if w is None:
        return None
    e_pad = int(table_d.shape[0])
    sa = np.fromiter((ep_slot[a] for _, a, _ in work), np.int32, len(work))
    sb = np.fromiter((ep_slot[b] for _, _, b in work), np.int32, len(work))
    plan = _dense_tile_plan(sa, sb, e_pad)
    ta_sz, tb_sz, uniq, order, bounds, origins = plan
    cells = len(uniq) * ta_sz * tb_sz
    if mode != "on" and cells > 4 * len(work):
        return None
    exp = expand_pm1(table_d, vtab_d, n_pad)
    n_bits = 2 * n_pad
    # work-row lookup: (slot_a, slot_b) -> row; the device mask restricts
    # flags to work cells, so every returned cell resolves
    wkey = sa.astype(np.int64) * e_pad + sb
    worder = np.argsort(wkey, kind="stable")
    wkey_sorted = wkey[worder]
    # Initial flag-word cap: 2 words per work cell of the DENSEST tile,
    # pow2-bucketed. The cap sizes the (widx, wvals) download per tile —
    # an 8*ta*tb cap would download ~66 MB of mostly -1 filler for the
    # dense-1000 shape; 2x the densest tile's cell count keeps
    # re-dispatches rare (~1 flagged diagonal-word per cell typical;
    # overflow re-dispatches pathological tiles at the next pow2 anyway).
    seg_max = int(np.max(np.diff(bounds))) if len(uniq) else 1
    cap0 = int(os.environ.get("NEEDLE_TPU_DIRECT_CAP", "0")) or _initial_cap(
        seg_max, ta_sz, tb_sz
    )
    # Work-membership masks for ALL tiles built host-side and uploaded in
    # ONE device_put (~half a MB) instead of one transfer per tile; the
    # per-dispatch mask becomes a device-side slice.
    mask_all = np.zeros((len(uniq), ta_sz, tb_sz), bool)
    for t, (a0, b0) in enumerate(origins):
        sel = order[bounds[t] : bounds[t + 1]]
        mask_all[t, sa[sel] - a0, sb[sel] - b0] = True
    mask_all_d = jax.device_put(mask_all)

    def dispatch(t, cap):
        a0, b0 = origins[t]
        return _tile_diag_flags(
            exp, np.int32(a0), np.int32(b0), mask_all_d[t],
            w, threshold, n_pad, ta_sz, tb_sz, cap,
        )

    launched = [dispatch(t, cap0) for t in range(len(uniq))]
    got = jax.device_get(launched)
    rows_parts, offs_parts = [], []
    for t, ((a0, b0), (widx, wvals, total)) in enumerate(zip(origins, got)):
        total = int(total)
        cap = cap0
        while total > cap:
            # pathological tile (pervasive self-similarity): re-dispatch
            # with the next pow2 cap — bucketed so compiles stay bounded
            cap = max(cap * 2, 1 << (total - 1).bit_length())
            widx, wvals, t2 = jax.device_get(dispatch(t, cap))
            total = int(t2)
        widx = widx[:total].astype(np.int64)
        wvals = np.asarray(wvals[:total], dtype=np.uint32)
        # expand set words to bit positions (same recipe as the
        # count-kernel bitmask unpack)
        bitmat = (wvals[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        sub_r, sub_k = np.nonzero(bitmat)
        fpos = widx[sub_r] * 32 + sub_k
        cell = fpos // n_bits
        bit = fpos % n_bits
        la, lb = cell // tb_sz, cell % tb_sz
        skey = (la + a0) * e_pad + (lb + b0)
        pos = np.searchsorted(wkey_sorted, skey)
        rows_parts.append(worder[pos])
        offs_parts.append(bit - (n_pad - 1))
    if rows_parts:
        return (
            np.concatenate(rows_parts),
            np.concatenate(offs_parts),
        )
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


def prefilter_band_masks(
    table_d, vtab_d, work, ep_slot, lm_of, threshold, n_pad
):
    """Band-level prefilter for the Triton walk.

    Returns (kept_work, masks, n_skipped, w): `masks` is an
    (len(kept_work), n_groups) i32 array of per-(pair, group) row-block
    bitmasks for `triton_walk.batch_counts`, or None when the
    prefilter doesn't apply (mode off / threshold too loose / bucket too
    long for a 31-bit mask) — callers then walk everything.

    Soundness (on top of the module-docstring block bound): a qualifying
    run has length >= l_min >= 2W - 1, so EVERY aligned W-block fully
    inside it qualifies; those blocks are consecutive, the first starts
    <= r0 + W - 1 and the last ends > r1 - W, so the union of
    [bW - W + 1, bW + 2W) over qualifying cells covers the run's entire
    row extent [r0, r1). Marking the kernel row blocks (512 rows each,
    block B covers i in [B*512 - 1, (B+1)*512 - 1)) that intersect that
    margin interval therefore marks every block containing ANY row of ANY
    qualifying run of the cell's diagonal group — cleared blocks are
    provably run-free and the kernel may skip them (with a carry flush;
    see triton_walk). Pairs whose mask is all-zero have no
    qualifying run anywhere and are dropped entirely (subsumes the
    pair-level skip). Unlike `prefilter_pairs`, there is no dense-library
    probe: dense same-show pairs are exactly where the band bounds pay,
    localizing the walk to the run's diagonal band instead of every
    (row, diagonal) cell."""
    if not work:
        return work, None, 0, None
    min_lm = min(lm_of(p) for p, _, _ in work)
    w = prefilter_plan(len(work), min_lm, threshold, n_pad)
    n_blocks = n_row_blocks(n_pad)
    if w is None or n_blocks > 31:
        return work, None, 0, None
    # membership marks exactly 2 blocks per cell; needs the margin interval
    # (length 3W - 1) to span <= 2 row blocks
    assert 3 * w - 1 <= D_TILE, (w, D_TILE)
    gd = GROUP_DIAGS
    n_groups = n_groups_for(n_pad)
    exp = expand_pm1(table_d, vtab_d, n_pad)
    sa = np.fromiter((ep_slot[a] for _, a, _ in work), np.int32, len(work))
    sb = np.fromiter((ep_slot[b] for _, _, b in work), np.int32, len(work))
    # Episode-factorized path: when the work list is
    # DENSE in episode-pair space (the all-pairs Comparator always is),
    # correlate episode tiles against episode tiles — per-pair gathers
    # disappear and the pass is pure matmul. The cell gate keeps the
    # per-pair path for sparse work lists, where tile rectangles would
    # compute mostly unneeded pairs.
    e_pad = int(table_d.shape[0])
    dense_mode = os.environ.get("NEEDLE_TPU_PREFILTER_DENSE", "auto")
    plan = None
    if dense_mode != "off":
        plan = _dense_tile_plan(sa, sb, e_pad)
        ta_sz, tb_sz, uniq = plan[0], plan[1], plan[2]
        cells = len(uniq) * ta_sz * tb_sz
        if dense_mode != "on" and cells > 4 * len(work):
            plan = None
    if plan is not None:
        masks = _band_masks_dense(
            exp, sa, sb, w, threshold, n_pad, gd, n_groups, n_blocks, plan
        )
    else:
        # bounds the (chunk, n_pad, 32) bf16 gathers to ~42 MB; 256 was
        # tuned for the accelerator this code was first written for and is
        # untuned on the H100
        chunk = int(os.environ.get("NEEDLE_TPU_PREFILTER_CHUNK", "256"))
        outs = []
        for c0 in range(0, len(work), chunk):
            n_batch = min(chunk, len(work) - c0)
            ia = np.zeros((chunk,), np.int32)
            ib = np.zeros((chunk,), np.int32)
            ia[:n_batch] = sa[c0 : c0 + n_batch]
            ib[:n_batch] = sb[c0 : c0 + n_batch]
            outs.append(
                _chunk_band_masks(
                    exp, ia, ib, w, threshold, n_pad, gd, n_groups, n_blocks
                )
            )
        # one coalesced device->host transfer (2 KB per chunk):
        # dispatches pipeline instead of syncing per chunk
        masks = np.concatenate(jax.device_get(outs))[: len(work)]
    keep = masks.any(axis=1)
    kept = [wk for wk, k in zip(work, keep) if k]
    return kept, masks[keep], int(len(work) - len(kept)), w


def prefilter_pairs(table_d, vtab_d, work, ep_slot, lm_of, threshold, n_pad):
    """Compact `work` [(p_idx, a, b), ...] to the pairs that can contain a
    qualifying run. Returns (kept_work, n_skipped, w_used).

    lm_of: p_idx -> l_min (cells). The block width is derived from the
    smallest l_min over the work list, so the test is sound for every
    pair. In auto mode the first ~2048 pairs act as a probe: if almost
    nothing is skippable (dense single-show libraries — search300/1000's
    shape), the remaining pairs are passed through unfiltered so the
    dense case pays ~0.2 s instead of ~15% of the walk. The probe's own
    masks are still applied — they are sound regardless. Two coalesced
    device->host transfers at most."""
    if not work:
        return work, 0, None
    min_lm = min(lm_of(p) for p, _, _ in work)
    w = prefilter_plan(len(work), min_lm, threshold, n_pad)
    if w is None:
        return work, 0, None
    exp = expand_pm1(table_d, vtab_d, n_pad)
    chunk = 256  # bounds the (chunk, n_pad, 32) bf16 gathers to ~42 MB
    bound = keep_bound(w, threshold)
    adaptive = (
        os.environ.get("NEEDLE_TPU_SEARCH_PREFILTER", "auto") == "auto"
    )
    probe_pairs = 8 * chunk

    def masks_for(span_work):
        sa = np.fromiter(
            (ep_slot[a] for _, a, _ in span_work), np.int32, len(span_work)
        )
        sb = np.fromiter(
            (ep_slot[b] for _, _, b in span_work), np.int32, len(span_work)
        )
        masks = []
        for c0 in range(0, len(span_work), chunk):
            n_batch = min(chunk, len(span_work) - c0)
            ia = np.zeros((chunk,), np.int32)
            ib = np.zeros((chunk,), np.int32)
            ia[:n_batch] = sa[c0 : c0 + n_batch]
            ib[:n_batch] = sb[c0 : c0 + n_batch]
            best = _chunk_max_corr(exp, ia, ib, w, threshold, n_pad)
            masks.append(best >= bound)
        flat = np.concatenate(jax.device_get(masks))[: len(span_work)]
        return flat

    if adaptive and len(work) > probe_pairs:
        head, tail = work[:probe_pairs], work[probe_pairs:]
        head_mask = masks_for(head)
        skip_frac = 1.0 - head_mask.mean()
        if skip_frac < 0.15:
            kept = [
                wk for wk, keep in zip(head, head_mask) if keep
            ] + tail
            return kept, len(work) - len(kept), w
        flat = np.concatenate([head_mask, masks_for(tail)])
    else:
        flat = masks_for(work)
    kept = [wk for wk, keep in zip(work, flat) if keep]
    return kept, len(work) - len(kept), w
