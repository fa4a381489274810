"""Plain PyTorch versions of the block kernels and of the superstep
megakernel (resident and streamed), and the block kernels' bit oracles.

They are the CPU path of every kernel wrapper, the ``"reference"`` backend,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card. They
call library routines (``torch.linalg.solve_triangular``, ``einsum``,
``index_add_``), so nothing on the ``"cuda"`` or ``"fused"`` backend's path
calls them with a CUDA tensor.
"""
from __future__ import annotations

import torch


def block_trsv_ref(diag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense lower-triangular solve: ``diag`` (k,B,B) with a single
    right-hand side per tile ``(k,B)`` or an R-column panel ``(k,B,R)``."""
    multi = rhs.ndim == 3
    r = rhs if multi else rhs.unsqueeze(-1)
    sol = torch.linalg.solve_triangular(diag, r, upper=False)
    return sol if multi else sol.squeeze(-1)


def block_trsv_panel_ref(diag: torch.Tensor, rhs: torch.Tensor, panel: int = 8) -> torch.Tensor:
    """The panel forward substitution of ``diag`` (k,B,B) with ``rhs`` (k,B),
    in the reference's order (``_trsv_panel_kernel``): for each panel of
    ``panel`` rows, a row sweep over the panel's own prefix, then the rank-P
    update ``r -= L[:, base:base+P] @ x[base:base+P]`` of the rows below the
    panel. ``B % panel == 0``."""
    k, B = rhs.shape
    x = torch.zeros_like(rhs)
    r = rhs.clone()
    for base in range(0, B, panel):
        for i in range(base, base + panel):
            s = (diag[:, i, base:i] * x[:, base:i]).sum(-1)
            x[:, i] = (r[:, i] - s) / diag[:, i, i]
        upd = torch.einsum("kij,kj->ki", diag[:, base + panel:, base:base + panel],
                           x[:, base:base + panel])
        r[:, base + panel:] = r[:, base + panel:] - upd
    return x


def block_gemv_ref(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Batched tile products: tiles (m,B,B) with xs (m,B) or (m,B,R)."""
    if xs.ndim == 3:
        return torch.einsum("mij,mjr->mir", tiles, xs)
    return torch.einsum("mij,mj->mi", tiles, xs)


# Bit oracles: the CUDA kernels' summation order, emulated one float32
# operation at a time, for blocks of at most one warp (B <= 32). Lane l of a
# warp holds the product of column l (fmaf(a, b, 0.f): a*b rounded once, -0
# made +0) and lanes past the row's end hold +0; the xor butterfly then adds
# to every lane its partner's value at offsets 16, 8, 4, 2, 1. The kernels
# hold themselves to these on the card (``tests/test_torch_cuda.py``,
# ``chip_smoke.py`` phase 2); the library versions above sum in other orders.
WARP = 32


def _check_block(B: int) -> None:
    if B > WARP:
        raise ValueError(f"bit oracles take blocks of at most {WARP}, got B = {B}")


def _butterfly(products: torch.Tensor) -> torch.Tensor:
    """The xor butterfly's sum over the last dim (at most 32 lanes, padded
    with +0 to 32); every lane ends with these bits."""
    v = torch.nn.functional.pad(products + 0.0, (0, WARP - products.shape[-1]))
    lanes = torch.arange(WARP, device=v.device)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def gemv_bits_ref(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """:func:`block_gemv_ref` with the bits of the GEMV family's kernels
    (GEMV, grouped GEMV, every GEMM column): tiles (m,B,B) with xs (m,B) or
    (m,B,R), B <= 32."""
    _check_block(tiles.shape[-1])
    if xs.ndim == 3:
        return _butterfly(tiles[:, None] * xs.transpose(1, 2)[:, :, None, :]).transpose(1, 2)
    return _butterfly(tiles * xs[:, None, :])


def rowsweep_bits_ref(diag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """:func:`block_trsv_ref` with the bits of the row-sweep kernels (TRSV,
    every TRSM column): row i sums L[i, :i] * x[:i] as the GEMV family sums
    a row, then x[i] = (r[i] - s) / L[i, i], each rounded to float32.
    ``diag`` (k,B,B) with ``rhs`` (k,B) or (k,B,R), B <= 32."""
    _check_block(diag.shape[-1])
    r = rhs if rhs.ndim == 3 else rhs[..., None]
    x = torch.zeros_like(r)
    for i in range(r.shape[1]):
        s = _butterfly(diag[:, i, None, :i] * x[:, :i].transpose(1, 2))
        x[:, i] = (r[:, i] - s) / diag[:, i, i, None]
    return x if rhs.ndim == 3 else x[..., 0]


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` on float32 tensors: ``a * b + c`` rounded once.
    The product of two float32 values is exact in float64; the sum is
    rounded to odd there (TwoSum gives its error; an inexact sum whose last
    bit is even moves one float64 step towards the exact value), and
    rounding that to float32 rounds the exact sum once, since 53 >= 2 * 24
    + 2. Finite values whose sum does not overflow."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def panel_bits_ref(diag: torch.Tensor, rhs: torch.Tensor, panel: int = 8) -> torch.Tensor:
    """:func:`block_trsv_panel_ref` with the bits of the panel kernels:
    row i of the panel starting at ``base`` sums L[i, base:i] * x[base:i]
    with the butterfly (column j on lane j - base), then x[i] = (r[i] - s)
    / L[i, i]; after the panel each row i below it subtracts u, an FMA
    chain from 0 over the panel's columns in order (:func:`fmaf`).
    ``diag`` (k,B,B) with ``rhs`` (k,B), B <= 32, ``B % panel == 0``."""
    _check_block(diag.shape[-1])
    B = rhs.shape[1]
    if panel < 1 or B % panel:
        raise ValueError(f"block size {B} is not a multiple of panel {panel}")
    r, x = rhs.clone(), torch.zeros_like(rhs)
    for base in range(0, B, panel):
        end = base + panel
        for i in range(base, end):
            s = _butterfly(diag[:, i, base:i] * x[:, base:i])
            x[:, i] = (r[:, i] - s) / diag[:, i, i]
        u = torch.zeros_like(r[:, end:])
        for j in range(base, end):
            u = fmaf(diag[:, end:, j], x[:, j, None].expand_as(u), u)
        r[:, end:] = r[:, end:] - u
    return x


def superstep_ref(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad, acc, x, stp=None,
                  delta=None):
    """The resident superstep megakernel's function, level by level: for
    each superstep ``seg[0] <= s < seg[0] + seg[1]`` and each of its levels
    ``stp[s] <= t < stp[s+1]`` in order, solve the level's rows
    ``sr[off[t,0]:][:wid[t,0]]`` (pad ``-1`` skipped) with
    ``rhs = b - acc``, then apply its tile updates
    ``acc[trow[j]] += tiles[j] @ x[tcol[j]]`` for ``j`` in
    ``ut[off[t,1]:][:wid[t,1]]``, in schedule order. ``stp=None`` means one
    level per superstep. Returns new ``(acc, x)``; the carries passed in are
    not modified. ``b_pad``/``acc``/``x`` are ``(nb+1, B)`` or ``(nb+1, B, R)``.

    With a ``delta`` carry (the reference's ``split_delta`` form, the
    unified executor's) the tile updates land in ``delta`` instead, solves
    read ``rhs = (b - acc) - delta``, ``acc`` passes through unchanged, and
    the result is ``(acc, delta, x)``.
    """
    split = delta is not None
    acc, x = acc.clone(), x.clone()
    if split:
        delta = delta.clone()
    if off.shape[0] == 0:
        return (acc, delta, x) if split else (acc, x)
    off_h, wid_h = off.tolist(), wid.tolist()
    s0, n_steps = (int(v) for v in seg.tolist())
    stp_h = list(range(off.shape[0] + 1)) if stp is None else stp.tolist()
    sr, ut, trow, tcol = (v.long() for v in (sr, ut, trow, tcol))
    for t in range(stp_h[s0], stp_h[s0 + n_steps]):
        o, w = off_h[t][0], wid_h[t][0]
        rows = sr[o:o + w]
        rows = rows[rows >= 0]
        if rows.numel():
            rhs = b_pad[rows] - acc[rows]
            if split:  # the reference's order: (b - acc) - delta
                rhs = rhs - delta[rows]
            x[rows] = block_trsv_ref(diag[rows], rhs)
        o, w = off_h[t][1], wid_h[t][1]
        if w:
            tids = ut[o:o + w]
            prods = block_gemv_ref(tiles[tids], x[tcol[tids]])
            if split:  # the tile updates land in delta
                delta.index_add_(0, trow[tids], prods)
            else:
                acc.index_add_(0, trow[tids], prods)
    if split:
        return acc, delta, x
    return acc, x


def stream_tiles(values: torch.Tensor, entries: torch.Tensor, B: int) -> torch.Tensor:
    """The (len(entries), B, B) tiles held at ``entries`` of a streamed store:
    each entry is a tile with rows padded to ``B + 1`` floats, then to a
    multiple of four (:func:`repro_torch.kernels.superstep.stream_tile_floats`)."""
    rows = values[entries.long(), :B * (B + 1)].reshape(-1, B, B + 1)
    return rows[:, :, :B].contiguous()


def superstep_streamed_ref(seg, off, wid, sr, ut, trow, tcol, values, diag_entry, tile_entry,
                           b_pad, acc, x, stp=None, delta=None):
    """:func:`superstep_ref` reading every tile from the streamed store
    ``values`` that the streamed kernel reads: slot ``k``'s diagonal tile at
    entry ``diag_entry[k]``, the tile of flat update position ``j`` at
    ``tile_entry[j]`` (``-1``: an update into the pad row, left out of the
    store, whose tile is the zero pad tile). It hands the same tensors to the
    same operations as :func:`superstep_ref`, so it gives its bits; with a
    ``delta`` carry, the split form, as there."""
    split = delta is not None
    acc, x = acc.clone(), x.clone()
    if split:
        delta = delta.clone()
    if off.shape[0] == 0:
        return (acc, delta, x) if split else (acc, x)
    B = b_pad.shape[1]
    off_h, wid_h = off.tolist(), wid.tolist()
    s0, n_steps = (int(v) for v in seg.tolist())
    stp_h = list(range(off.shape[0] + 1)) if stp is None else stp.tolist()
    sr, trow, tcol = (v.long() for v in (sr, trow, tcol))
    ut, diag_entry, tile_entry = ut.long(), diag_entry.long(), tile_entry.long()
    for t in range(stp_h[s0], stp_h[s0 + n_steps]):
        o, w = off_h[t][0], wid_h[t][0]
        live = sr[o:o + w] >= 0
        rows = sr[o:o + w][live]
        if rows.numel():
            L = stream_tiles(values, diag_entry[o:o + w][live], B)
            rhs = b_pad[rows] - acc[rows]
            if split:
                rhs = rhs - delta[rows]
            x[rows] = block_trsv_ref(L, rhs)
        o, w = off_h[t][1], wid_h[t][1]
        if w:
            tids, ent = ut[o:o + w], tile_entry[o:o + w]
            tiles = stream_tiles(values, ent.clamp(min=0), B)
            tiles[ent < 0] = 0.0
            prods = block_gemv_ref(tiles, x[tcol[tids]])
            if split:
                delta.index_add_(0, trow[tids], prods)
            else:
                acc.index_add_(0, trow[tids], prods)
    if split:
        return acc, delta, x
    return acc, x
