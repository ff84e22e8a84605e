"""Walk geometry shared by the search kernels and the band prefilter.

Rows of a pair are cut into blocks of D_TILE rows — block b covers rows
[b*D_TILE - 1, (b+1)*D_TILE - 1) — and diagonals into groups of
GROUP_DIAGS. The band prefilter (search/prefilter.py) emits one int32
bitmask per (pair, diagonal group) whose bit b says that row block b may
hold a qualifying run on some diagonal of the group; the walk kernel
(search/triton_walk.py) skips the cleared blocks. Both sides derive every
block and group bound from this module, so they agree bit for bit.
"""

from __future__ import annotations

import numpy as np

D_TILE = 512  # rows per block; also the diagonal width of one `tiles` tile
GROUP_DIAGS = 8 * D_TILE  # diagonals per band-mask group


def n_row_blocks(n_pad: int) -> int:
    """Row blocks that cover rows [-1, n_pad)."""
    return n_pad // D_TILE + 1


def n_groups_for(n_pad: int) -> int:
    """Band-mask groups covering the 2*n_pad - 1 diagonals of a pair."""
    return -(-(2 * n_pad - 1) // GROUP_DIAGS)


def full_block_mask(n_pad: int) -> np.int32:
    """Bitmask walking every row block (prefilter off or pass-through).
    For buckets too long for a 31-bit mask, -1 keeps every block (an
    arithmetic shift keeps the sign bit, so (bm >> b) & 1 == 1 for all
    b)."""
    n_blocks = n_row_blocks(n_pad)
    if n_blocks > 31:
        return np.int32(-1)
    return np.int32((np.int64(1) << n_blocks) - 1)
