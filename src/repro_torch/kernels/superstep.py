"""The resident superstep megakernel: a whole single-device solve in one launch.

Wrapper over ``csrc/superstep.cu`` (which says what it replaces, how levels
are separated on Hopper and what bounds it). :func:`superstep_call` takes the
reference's eight schedule tables and returns ``(acc, x)``; given CPU
tensors it returns the plain version (:func:`repro_torch.kernels.ref.superstep_ref`),
given CUDA tensors it makes one cooperative launch on the current stream or
raises. ``superstep_call.launches`` counts kernel launches, and nothing else.

The kernel pulls each row's tile updates right before it solves the row, so
it needs, besides the reference's tables, the host-built
:class:`SuperstepTable`: every solved row's incoming tiles in the order the
reference adds them. :func:`superstep_table` builds it once per plan; the
executor (``core/solver.py``) keeps it on the device beside the plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import extension, ref

WARPS_PER_CTA = 8  # kWarpsPerCta in csrc/superstep.cu
STAGE_FLOATS = 33 * 32  # kStage: a warp's buffer for tile rows, B + 1 floats apart


def shared_bytes(B: int) -> int:
    """Dynamic shared memory of one megakernel CTA: per warp, a staging
    buffer of ``STAGE_FLOATS`` floats for tile rows and two columns of ``B``
    floats (the row's sum and the tile's source column)."""
    return 4 * WARPS_PER_CTA * (STAGE_FLOATS + 2 * B)


@dataclasses.dataclass(frozen=True)
class SuperstepTable:
    """What the kernel needs beyond the reference's tables, for one launch.

    ``levels`` is the launch's level range ``[t_lo, t_hi)``. Target ``k <
    S`` is solve slot ``k`` (row ``sr[k]``); target ``S + q`` is orphan
    ``q``, row ``orphan_row[q]``, which receives updates in the launch but
    is not solved in it. ``pull_tile[pull_ptr[k]:pull_ptr[k+1]]`` are target
    ``k``'s incoming tiles in the reference's order: by level, then by
    position in the flat update schedule; ``pull_col`` holds their source
    rows (``tcol``). Updates into the pad row (the
    zero pad tile) are left out. ``copy_row`` are the rows the launch does
    not solve, whose ``x`` (and, but for orphans, ``acc``) the kernel copies
    from the carries passed in. ``max_items`` is the most work items (solve
    slots or orphans) of any phase, which sizes the grid.
    """

    levels: tuple
    pull_ptr: np.ndarray | torch.Tensor
    pull_tile: np.ndarray | torch.Tensor
    pull_col: np.ndarray | torch.Tensor
    orphan_row: np.ndarray | torch.Tensor
    copy_row: np.ndarray | torch.Tensor
    n_solve_slots: int
    n_orphans: int
    n_copy: int
    max_items: int

    def to(self, device) -> "SuperstepTable":
        """The same table with its arrays as int32 tensors on ``device``
        (an empty one padded to one entry, so every pointer is valid)."""
        def dev(a):
            a = np.asarray(a, np.int32)
            return torch.from_numpy(a if a.size else np.zeros(1, np.int32)).to(device)

        return dataclasses.replace(self, pull_ptr=dev(self.pull_ptr),
                                   pull_tile=dev(self.pull_tile),
                                   pull_col=dev(self.pull_col),
                                   orphan_row=dev(self.orphan_row),
                                   copy_row=dev(self.copy_row))


def _ranges(starts: np.ndarray, widths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated ``arange(s, s + w)`` over the pairs, and for each entry
    the index of its pair."""
    owner = np.repeat(np.arange(widths.shape[0]), widths)
    first = np.cumsum(widths) - widths
    return np.repeat(starts, widths) + np.arange(owner.shape[0]) - first[owner], owner


def superstep_table(seg, off, wid, sr, ut, trow, tcol, n_rows: int,
                    stp=None) -> SuperstepTable:
    """Build the pull table of one launch from host copies of the tables.

    Raises ``ValueError`` for tables the pull order cannot reproduce: a row
    solved twice, an update into a row at or after the row's own level, or
    an update that reads a row solved at a later level. Plans from
    ``core.solver.build_plan`` have none of them.
    """
    seg, off, wid, sr, ut, trow, tcol = (np.asarray(v, np.int64)
                                         for v in (seg, off, wid, sr, ut, trow, tcol))
    T = off.shape[0]
    stp = np.arange(T + 1) if stp is None else np.asarray(stp, np.int64)
    s0, n_steps = int(seg[0]), int(seg[1])
    if T == 0:
        t_lo = t_hi = 0
    elif 0 <= s0 and 0 <= n_steps and s0 + n_steps < stp.shape[0]:
        t_lo, t_hi = int(stp[s0]), int(stp[s0 + n_steps])
    else:
        raise ValueError(f"seg {seg.tolist()} is outside the {stp.shape[0] - 1} supersteps")
    levels = np.arange(t_lo, t_hi)
    pad = n_rows - 1

    slot, s_lvl = _ranges(off[levels, 0], wid[levels, 0])
    rows = sr[slot]
    live = rows >= 0
    slot, rows, s_lvl = slot[live], rows[live], levels[s_lvl[live]]
    if np.unique(rows).shape[0] != rows.shape[0]:
        raise ValueError("a row is solved twice in one launch")
    solve_level = np.full(n_rows, -1, np.int64)
    solve_level[rows] = s_lvl
    slot_of_row = np.full(n_rows, -1, np.int64)
    slot_of_row[rows] = slot

    pos, u_lvl = _ranges(off[levels, 1], wid[levels, 1])
    tid = ut[pos]
    u_lvl = levels[u_lvl]
    dest = trow[tid]
    live = dest != pad
    tid, dest, u_lvl = tid[live], dest[live], u_lvl[live]
    if np.any(solve_level[tcol[tid]] > u_lvl):
        raise ValueError("a tile update reads a row that is solved at a later level")
    d_lvl = solve_level[dest]
    if np.any((d_lvl >= 0) & (d_lvl <= u_lvl)):
        raise ValueError("a row receives a tile update at or after its own level")

    S = sr.shape[0]
    orphan_row = np.unique(dest[d_lvl < 0])
    target = np.where(d_lvl >= 0, slot_of_row[dest], S + np.searchsorted(orphan_row, dest))
    order = np.argsort(target, kind="stable")  # keeps the reference's order per target
    pull_ptr = np.zeros(S + orphan_row.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(target, minlength=S + orphan_row.shape[0]), out=pull_ptr[1:])
    copy_row = np.nonzero(solve_level < 0)[0]
    widest = int(wid[levels, 0].max()) if levels.size else 0
    return SuperstepTable(
        levels=(t_lo, t_hi), pull_ptr=pull_ptr.astype(np.int32),
        pull_tile=tid[order].astype(np.int32), pull_col=tcol[tid[order]].astype(np.int32),
        orphan_row=orphan_row.astype(np.int32),
        copy_row=copy_row.astype(np.int32), n_solve_slots=S,
        n_orphans=int(orphan_row.shape[0]), n_copy=int(copy_row.shape[0]),
        max_items=max(widest, int(orphan_row.shape[0])))


def _check(diag, tiles, b_pad, acc, x, tables) -> None:
    vecs = (b_pad, acc, x)
    if any(v.dtype != torch.float32 for v in (diag, tiles) + vecs):
        raise TypeError("superstep_call: float32 diag, tiles, b_pad, acc and x required")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("superstep_call: int32 schedule tables required")
    devices = {v.device for v in (diag, tiles) + vecs + tables}
    if len(devices) != 1:
        raise ValueError(f"superstep_call: operands on several devices {sorted(map(str, devices))}")
    if diag.device.type not in ("cpu", "cuda"):
        raise ValueError(f"superstep_call: unsupported device {diag.device}")
    if diag.ndim != 3 or diag.shape[1] != diag.shape[2] or tiles.shape[1:] != diag.shape[1:]:
        raise ValueError(f"superstep_call: diag (nb+1,B,B) and tiles (ML+1,B,B) required, "
                         f"got {tuple(diag.shape)}, {tuple(tiles.shape)}")
    if (b_pad.ndim not in (2, 3) or tuple(b_pad.shape[:2]) != tuple(diag.shape[:2])
            or acc.shape != b_pad.shape or x.shape != b_pad.shape):
        raise ValueError(f"superstep_call: b_pad, acc, x must be (nb+1,B[,R]) matching diag "
                         f"{tuple(diag.shape)}, got {tuple(b_pad.shape)}, {tuple(acc.shape)}, "
                         f"{tuple(x.shape)}")
    if not all(v.is_contiguous() for v in (diag, tiles) + vecs + tables):
        raise ValueError("superstep_call: operands must be contiguous")
    if diag.shape[1] + 1 > STAGE_FLOATS:  # the staging buffer holds one padded row
        raise ValueError(f"superstep_call: block size {diag.shape[1]} >= {STAGE_FLOATS}")


def superstep_call(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad, acc, x,
                   stp=None, *, grid: int = 0, table: SuperstepTable | None = None):
    """Run supersteps ``seg[0] .. seg[0] + seg[1] - 1`` of the schedule in
    one launch; returns new ``(acc, x)``, leaving the carries passed in as
    they were.

    The tables are the reference's (``kernels/superstep.py::superstep_call``
    in the JAX package), as int32 tensors on the operands' device; ``stp``
    ``None`` means one level per superstep. Unlike the reference, ``grid`` is
    the number of CTAs (0: enough for the widest level, at most what fits on
    the card at once; more than fits is refused, and raises), not a program
    per superstep: every superstep of ``seg`` runs. ``table`` is
    :func:`superstep_table` of the same tables, already on the device; when
    it is ``None`` the wrapper builds it from host copies. A launch with no
    level makes no kernel launch.
    """
    tables = tuple(t for t in (seg, off, wid, sr, ut, trow, tcol, stp) if t is not None)
    _check(diag, tiles, b_pad, acc, x, tables)
    if diag.device.type == "cpu":
        return ref.superstep_ref(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad,
                                 acc, x, stp)
    if table is None:
        host = [t.cpu().numpy() for t in (seg, off, wid, sr, ut, trow, tcol)]
        table = superstep_table(*host, n_rows=diag.shape[0],
                                stp=None if stp is None else stp.cpu().numpy()).to(diag.device)
    t_lo, t_hi = table.levels
    if t_hi == t_lo:
        return acc.clone(), x.clone()
    acc_out, x_out = torch.empty_like(acc), torch.empty_like(x)
    B = diag.shape[1]
    R = 1 if b_pad.ndim == 2 else b_pad.shape[2]
    ptrs = [t.data_ptr() for t in (off, wid, sr, table.pull_ptr, table.pull_tile,
                                   table.pull_col, table.orphan_row, table.copy_row, diag,
                                   tiles, b_pad, acc, x, acc_out, x_out)]
    sizes = [t_lo, t_hi, B] + ([] if R == 1 else [R]) + [
        table.n_solve_slots, table.n_orphans, table.n_copy, table.max_items, grid]
    fn = "repro_superstep_f32" if R == 1 else "repro_superstep_panel_f32"
    extension.launch("superstep", fn, diag.device, *ptrs, *sizes)
    superstep_call.launches += 1
    return acc_out, x_out


superstep_call.launches = 0

