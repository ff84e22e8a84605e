"""Diagonal-run walk for NVIDIA GPUs: a Pallas kernel through Triton.

Contract. For every pair p of a chunk and every diagonal offset
o = j - i in [-(n_pad-1), n_pad-1] (diagonal index d = o + n_pad - 1),
count the maximal runs of consecutive matching cells (i, i+o) that are
at least l_min cells long, where a cell matches when

    popcount(src[i] ^ dst[i+o]) <= thr,   1 <= i < nv,   1 <= i+o < mv

(the reference zeroes row and column 0 of its table, comparator.rs:179).
Per-pair scalars nv, mv, l_min and thr arrive with the chunk, so one
compiled program serves any mix of episode lengths.

Layout. One program per (pair, block of BLOCK_DIAGS diagonals); lane k
of the block owns diagonal d0 + k. Programs run in any order on the
card's SMs, so nothing is carried between them: each walks its rows
i = i_lo .. i_hi in a loop, with the run length and the candidate count
of every lane in registers. Per row it reads src[i] as one scalar and
dst[i + d0 .. i + d0 + BLOCK_DIAGS) as one contiguous vector (dst is
zero-padded by BLOCK_DIAGS on both sides, so every load is in bounds and
the hash rows stay in L1/L2), XORs, popcounts and updates the carry.
Device memory traffic is the two hash rows in and one count row out,
against the tens of bytes per (row, diagonal) cell that the XLA `tiles`
formulation materializes.

Row bounds. A row can match on some lane only if i in [1, nv) and
i + o in [1, mv) for some o of the block, i.e. i >= 1 - o_max and
i < mv - o_min. Rows outside are all non-matching, so walking only the
rest — from a zero carry, with the final-edge accounting below — gives
the same counts as the full walk.

Band masks. `bm[p, g]` (search/prefilter.py `prefilter_band_masks`) has
bit b set when row block b (search/geometry.py) may contain a row of a
qualifying run on some diagonal of group g. A cleared block is skipped,
and the carry is flushed at the gap: a live run with run >= l_min at the
gap is qualifying, so it cannot extend into the gap and ends there —
counting it at the flush equals the full walk's accounting; a live run
with run < l_min could only reach l_min by putting qualifying-run rows
inside the gap, so dropping it drops only runs the full walk would also
drop. All-ones masks reduce the kernel to the plain bounded walk.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .geometry import D_TILE, GROUP_DIAGS, full_block_mask, n_groups_for

BLOCK_DIAGS = 256  # diagonals (lanes) per program; divides GROUP_DIAGS
NUM_WARPS = 4
# Tests set this to run the kernel in the Pallas interpreter on the CPU;
# on the card the kernel always runs compiled.
INTERPRET = False


def n_diag_blocks(n_pad: int) -> int:
    return -(-(2 * n_pad - 1) // BLOCK_DIAGS)


def _popcount(x, interpret):
    """Per-lane popcount of u32 x as int32. Compiled, it is the PTX
    `popc.b32` instruction: the Triton that XLA bundles does not legalize
    the `math.ctpop` that `lax.population_count` lowers to. The
    interpreter runs `lax.population_count`, which computes the same."""
    if interpret:
        return jax.lax.population_count(x).astype(jnp.int32)
    [out] = plt.elementwise_inline_asm(
        "popc.b32 $0, $1;",
        args=[x],
        constraints="=r,r",
        pack=1,
        result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.int32)],
    )
    return out


def _walk_kernel(
    meta_ref, bm_ref, src_ref, dst_ref, out_ref, *, n_pad, interpret
):
    g = pl.program_id(1)
    nv = meta_ref[0]
    mv = meta_ref[1]
    l_min = jnp.maximum(meta_ref[2], 1)
    thr = meta_ref[3]
    bm = bm_ref[(g * BLOCK_DIAGS) // GROUP_DIAGS]

    d0 = g * BLOCK_DIAGS - (n_pad - 1)  # offset of lane 0
    off = d0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK_DIAGS,), 0)
    i_lo = jnp.maximum(1, 1 - (d0 + BLOCK_DIAGS - 1))
    i_hi = jnp.minimum(nv - 1, mv - 1 - d0)  # inclusive

    def row(i, carry):
        run, cand = carry
        s = src_ref[i]
        dv = dst_ref[pl.ds(i + d0 + BLOCK_DIAGS, BLOCK_DIAGS)]
        j = i + off
        hit = (
            (_popcount(s ^ dv, interpret) <= thr)
            & (j >= 1)
            & (j < mv)
        )
        # a run ends where a matching row is followed by a miss
        cand = cand + jnp.where(~hit & (run >= l_min), 1, 0)
        run = jnp.where(hit, run + 1, 0)
        return run, cand

    def block(b, carry):
        allowed = ((bm >> jnp.minimum(b, 31)) & 1) == 1
        lo = jnp.maximum(b * D_TILE - 1, i_lo)
        hi = jnp.where(allowed, jnp.minimum((b + 1) * D_TILE - 1, i_hi + 1), lo)
        run, cand = jax.lax.fori_loop(lo, hi, row, carry)
        # a skipped block closes every live run (module docstring)
        cand = cand + jnp.where(~allowed & (run >= l_min), 1, 0)
        run = jnp.where(allowed, run, 0)
        return run, cand

    zero = jnp.zeros((BLOCK_DIAGS,), jnp.int32)
    b_lo = (i_lo + 1) // D_TILE
    b_hi = (i_hi + 1) // D_TILE + 1
    run, cand = jax.lax.fori_loop(b_lo, b_hi, block, (zero, zero))
    # runs still live after the last row end at the array edge
    out_ref[...] = cand + jnp.where(run >= l_min, 1, 0)


@functools.partial(jax.jit, static_argnames=("n_pad", "interpret"))
def _walk_counts(meta, bm, src, dst, n_pad, interpret=False):
    chunk = src.shape[0]
    n_blocks = n_diag_blocks(n_pad)
    n_groups = bm.shape[1]
    dst_pad = jnp.pad(dst, ((0, 0), (BLOCK_DIAGS, BLOCK_DIAGS)))
    return pl.pallas_call(
        functools.partial(_walk_kernel, n_pad=n_pad, interpret=interpret),
        grid=(chunk, n_blocks),
        in_specs=[
            pl.BlockSpec((None, 4), lambda p, g: (p, 0)),
            pl.BlockSpec((None, n_groups), lambda p, g: (p, 0)),
            pl.BlockSpec((None, n_pad), lambda p, g: (p, 0)),
            pl.BlockSpec((None, n_pad + 2 * BLOCK_DIAGS), lambda p, g: (p, 0)),
        ],
        out_specs=pl.BlockSpec((None, BLOCK_DIAGS), lambda p, g: (p, g)),
        out_shape=jax.ShapeDtypeStruct(
            (chunk, n_blocks * BLOCK_DIAGS), jnp.int32
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="needle_diag_walk",
    )(meta, bm, src, dst_pad)


def batch_counts(nv, mv, lm, thr, src, dst, n_pad, bm=None, interpret=False):
    """(chunk, n_pad) u32 src/dst hash rows + per-pair scalars ->
    per-diagonal candidate counts, (chunk, n_diag_blocks*BLOCK_DIAGS)
    int32; column d is the diagonal at offset d - (n_pad - 1). `bm`
    ((chunk, n_groups_for(n_pad)) int32, optional) holds band masks;
    None walks every row block."""
    chunk = np.shape(src)[0]
    if bm is None:
        bm = np.full((chunk, n_groups_for(n_pad)), full_block_mask(n_pad),
                     np.int32)
    meta = jnp.stack(
        [jnp.asarray(v, jnp.int32) for v in (nv, mv, lm, thr)], axis=1
    )
    return _walk_counts(meta, bm, src, dst, n_pad, interpret=interpret)
