"""B×B dense-block tiling of a sparse lower-triangular matrix.

Block adaptation of the paper's scalar component model: scalar dependency
chains leave wide vector hardware idle, so the dependency graph is lifted to
the *block quotient graph*. Block-row ``bi`` owns components
``[bi*B, (bi+1)*B)``; the diagonal tile is solved by a dense block-TRSV kernel
and each off-diagonal tile ``(bi, bj)`` contributes a block GEMV update.
All paper concepts (in-degree, level-sets, task partitioning, boundary
exchange) then operate on block-rows instead of components.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.matrix import CSR


@dataclasses.dataclass(frozen=True)
class BlockStructure:
    """Dense-tile block-sparse view of lower-triangular L (padded to nb*B)."""

    n: int  # original dimension
    B: int  # tile size
    nb: int  # number of block rows = ceil(n/B)
    diag: np.ndarray  # (nb, B, B) dense diagonal tiles (unit-padded)
    off_rows: np.ndarray  # (m,) block-row id of each strictly-lower tile
    off_cols: np.ndarray  # (m,) block-col id of each strictly-lower tile
    off_tiles: np.ndarray  # (m, B, B) dense tile values
    block_level: np.ndarray  # (nb,) level of each block row in the quotient DAG
    block_indeg: np.ndarray  # (nb,) #distinct predecessor tiles per block row

    @property
    def n_tiles(self) -> int:
        return int(self.off_rows.shape[0])

    @property
    def n_block_levels(self) -> int:
        return int(self.block_level.max()) + 1 if self.nb else 0


def _assemble_tiles(a: CSR, B: int, nb: int):
    """Numeric tile assembly: ``(diag, off_tiles, tile_keys)``.

    The single source of the dense-tile value layout, shared by
    :func:`build_blocks` and :func:`refresh_block_values` — the refresh
    path's bit-identity guarantee is by construction, not by keeping two
    copies in sync. ``tile_keys`` is the sorted ``brow * nb + bcol`` id per
    strictly-lower tile.
    """
    rows = np.repeat(np.arange(a.n, dtype=np.int64), np.diff(a.row_ptr))
    cols = a.col_idx.astype(np.int64)
    vals = a.val
    brow, bcol = rows // B, cols // B

    # --- diagonal tiles ---
    diag = np.zeros((nb, B, B), dtype=np.float32)
    eye_idx = np.arange(B)
    diag[:, eye_idx, eye_idx] = 1.0  # padding rows become identity (inert)
    dmask = brow == bcol
    diag[brow[dmask], rows[dmask] % B, cols[dmask] % B] = vals[dmask]

    # --- strictly-lower tiles (dense) ---
    omask = ~dmask
    key = brow[omask] * nb + bcol[omask]
    uniq, inv = np.unique(key, return_inverse=True)
    off_tiles = np.zeros((uniq.shape[0], B, B), dtype=np.float32)
    off_tiles[inv, rows[omask] % B, cols[omask] % B] = vals[omask]
    return diag, off_tiles, uniq


def build_blocks(a: CSR, B: int) -> BlockStructure:
    nb = -(-a.n // B)
    diag, off_tiles, uniq = _assemble_tiles(a, B, nb)
    off_rows = (uniq // nb).astype(np.int32)
    off_cols = (uniq % nb).astype(np.int32)

    # --- quotient-graph analysis (block in-degree & level-sets) ---
    indeg = np.bincount(off_rows, minlength=nb).astype(np.int32)
    lvl = np.zeros(nb, dtype=np.int32)
    order = np.argsort(off_rows, kind="stable")
    sr, sc = off_rows[order], off_cols[order]
    ptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(sr, minlength=nb), out=ptr[1:])
    for bi in range(nb):
        lo, hi = ptr[bi], ptr[bi + 1]
        if hi > lo:
            lvl[bi] = lvl[sc[lo:hi]].max() + 1
    return BlockStructure(
        n=a.n, B=B, nb=nb, diag=diag, off_rows=off_rows, off_cols=off_cols,
        off_tiles=off_tiles, block_level=lvl, block_indeg=indeg,
    )


def refresh_block_values(bs: BlockStructure, a: CSR) -> BlockStructure:
    """New :class:`BlockStructure` carrying ``a``'s numeric values on ``bs``'s
    exact tile pattern — the numeric half of :func:`build_blocks` without the
    quotient-graph analysis (levels/in-degrees are pattern properties and are
    reused). Raises ``ValueError`` when ``a``'s block pattern differs.
    """
    B, nb = bs.B, bs.nb
    if a.n != bs.n:
        raise ValueError(f"matrix size changed: n={a.n}, analysis has n={bs.n}")
    diag, off_tiles, uniq = _assemble_tiles(a, B, nb)
    if not np.array_equal(
        uniq, bs.off_rows.astype(np.int64) * nb + bs.off_cols.astype(np.int64)
    ):
        raise ValueError(
            "sparsity pattern mismatch: numeric refresh requires the same "
            "tile pattern the analysis was built on"
        )
    return dataclasses.replace(bs, diag=diag, off_tiles=off_tiles)


def pad_rhs(b: np.ndarray, bs: BlockStructure) -> np.ndarray:
    """(n,) -> (nb, B) block layout; (n, k) RHS panels -> (nb, B, k)."""
    b = np.asarray(b, dtype=np.float32)
    out = np.zeros((bs.nb * bs.B,) + b.shape[1:], dtype=np.float32)
    out[: bs.n] = b
    return out.reshape((bs.nb, bs.B) + b.shape[1:])


def unpad_x(xb: np.ndarray, bs: BlockStructure) -> np.ndarray:
    xb = np.asarray(xb)
    return xb.reshape((-1,) + xb.shape[2:])[: bs.n]
