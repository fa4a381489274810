"""The superstep megakernel: a whole single-device solve in one launch, or
one superstep of a multi-device ``comm="unified"`` solve (the split form),
resident or streamed.

Wrapper over ``csrc/superstep.cu`` (which says what it replaces, how rows
wait for the rows they pull from on Hopper and what bounds it).
:func:`superstep_call` takes the reference's eight schedule tables and
returns ``(acc, x)``; given CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.superstep_ref`), given CUDA tensors it makes
one cooperative launch on the current stream or raises.
:func:`superstep_streamed_call` is the same function with every tile read
from the streamed store (:func:`streamed_layout`, :func:`streamed_values`),
which the kernel copies into shared memory with asynchronous bulk copies
issued ahead of use. Given a ``delta`` carry, both run the split form (the
reference's ``split_delta=True``: updates into ``delta``, solves with
``(b - acc) - delta``) on copies of the carries; :func:`superstep_split_`
and :func:`superstep_streamed_split_` launch it in place, as the unified
executor does once per superstep, each solve's tables built once
(:func:`segmented_layout`). ``launches`` on each of the four counts its
kernel launches, and nothing else.

The kernel pulls each row's tile updates right before it solves the row, so
it needs, besides the reference's tables, the host-built
:class:`SuperstepTable`: every solved row's incoming tiles in the order the
reference adds them. :func:`superstep_table` builds it once per plan; the
executor (``core/solver.py``) keeps it on the device beside the plan, with
the :class:`ReadyFlags` scratch through which a row tells the rows that pull
from it that it is solved.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import extension, ref

WARPS_PER_CTA = 8  # kWarpsPerCta in csrc/superstep.cu
STAGE_FLOATS = 33 * 32  # kStage: one stage of tile rows, B + 1 floats apart
RING = 3  # kRing: the resident kernel's stages per warp
CHUNK_STAGES = 2  # kChunkStages: the row-chunked streamed kernel's stages per CTA
SHARED_LIMIT = 232_448  # dynamic shared memory one Hopper block may use (227 KB)
EPOCH_LIMIT = 2**31 - 1  # the largest flag value (int32); ReadyFlags re-zeros past it


def shared_bytes(B: int) -> int:
    """Dynamic shared memory of one resident megakernel CTA: per warp, a
    ring of ``RING`` stages of ``STAGE_FLOATS`` floats for prefetched tile
    rows and three columns of ``B`` floats (the row's sum and two source
    columns, read together)."""
    return 4 * WARPS_PER_CTA * (RING * STAGE_FLOATS + 3 * B)


class ReadyFlags:
    """The megakernel's per-row ready flags: for each ``R``, an int32 array
    of ``n_rows * R`` flags on ``device``, allocated zeroed at first use and
    kept. The warp that solves row ``r``, column ``c`` sets
    ``flags[r * R + c]`` to the launch's epoch; a warp that pulls from that
    row waits for it. :meth:`next` returns the array and a fresh epoch, one
    more than the last launch's, so the flags are never cleared between
    launches; once the epoch would pass :data:`EPOCH_LIMIT` every array is
    zeroed (on the current stream) and the count starts again at 1. One
    ``ReadyFlags`` serves launches on one stream, one after another.
    """

    def __init__(self, n_rows: int, device):
        self.n_rows = int(n_rows)
        self.device = torch.device(device)
        self.epoch = 0  # the last launch's
        self._flags: dict[int, torch.Tensor] = {}

    def flags(self, R: int) -> torch.Tensor:
        """The ``(n_rows * R,)`` int32 flags of ``R``-column launches."""
        if R not in self._flags:
            self._flags[R] = torch.zeros(self.n_rows * R, dtype=torch.int32, device=self.device)
        return self._flags[R]

    def next(self, R: int) -> tuple[torch.Tensor, int]:
        """The flags of an ``R``-column launch and the launch's epoch."""
        flags = self.flags(R)
        if self.epoch >= EPOCH_LIMIT:
            for f in self._flags.values():
                f.zero_()
            self.epoch = 0
        self.epoch += 1
        return flags, self.epoch


@dataclasses.dataclass(frozen=True)
class SuperstepTable:
    """What the kernel needs beyond the reference's tables, for one launch.

    ``levels`` is the launch's level range ``[t_lo, t_hi)``. Target ``k <
    S`` is solve slot ``k`` (row ``sr[k]``); target ``S + q`` is orphan
    ``q``, row ``orphan_row[q]``, which receives updates in the launch but
    is not solved in it. ``pull_tile[pull_ptr[k]:pull_ptr[k+1]]`` are target
    ``k``'s incoming tiles in the reference's order: by level, then by
    position in the flat update schedule; ``pull_col`` holds their source
    rows (``tcol``), and ``pull_wait`` is 1 where that row is solved in the
    launch (the kernel waits for its flag) and 0 where it is not (its ``x``
    is the carry passed in, copied before any row is solved). Updates into
    the pad row (the zero pad tile) are left out. ``copy_row`` are the rows
    the launch does not solve, whose ``x`` (and, but for orphans, ``acc``)
    the kernel copies from the carries passed in. ``max_items`` is the most work items (solve
    slots or orphans) of any phase, which sizes the grid.

    A launch that is one segment of a longer solve (:class:`SegmentedLayout`)
    shares its arrays with the other segments: target ``k``'s first pull is
    ``pull_ptr[ptr_at + k]`` and orphan ``q``'s row ``orphan_row[orphan_at +
    q]``; ``n_solve_slots`` is the end of the segment's solve slots, and it
    copies nothing (the split form updates its carries in place).
    """

    levels: tuple
    pull_ptr: np.ndarray | torch.Tensor
    pull_tile: np.ndarray | torch.Tensor
    pull_col: np.ndarray | torch.Tensor
    pull_wait: np.ndarray | torch.Tensor
    orphan_row: np.ndarray | torch.Tensor
    copy_row: np.ndarray | torch.Tensor
    n_solve_slots: int
    n_orphans: int
    n_copy: int
    max_items: int
    ptr_at: int = 0
    orphan_at: int = 0

    def to(self, device) -> "SuperstepTable":
        """The same table with its arrays as int32 tensors on ``device``
        (an empty one padded to one entry, so every pointer is valid)."""
        def dev(a):
            a = np.asarray(a, np.int32)
            return torch.from_numpy(a if a.size else np.zeros(1, np.int32)).to(device)

        return dataclasses.replace(self, pull_ptr=dev(self.pull_ptr),
                                   pull_tile=dev(self.pull_tile),
                                   pull_col=dev(self.pull_col),
                                   pull_wait=dev(self.pull_wait),
                                   orphan_row=dev(self.orphan_row),
                                   copy_row=dev(self.copy_row))


def _ranges(starts: np.ndarray, widths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated ``arange(s, s + w)`` over the pairs, and for each entry
    the index of its pair."""
    owner = np.repeat(np.arange(widths.shape[0]), widths)
    first = np.cumsum(widths) - widths
    return np.repeat(starts, widths) + np.arange(owner.shape[0]) - first[owner], owner


def _updates(off, wid, sr, ut, trow, tcol, n_rows: int, levels: np.ndarray) -> dict:
    """The solves and tile updates of ``levels`` (int64 host tables), with
    the checks :func:`superstep_table` documents: every live solve slot
    (``slot``, its ``row`` and level), the row's solve level
    (``solve_level``, -1 if not solved there) and slot, and every update into
    a real row (flat position ``pos``, tile ``tid``, ``dest`` row, source
    level ``u_lvl``), in flat order."""
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
    pos, tid, dest, u_lvl = pos[live], tid[live], dest[live], u_lvl[live]
    if np.any(solve_level[tcol[tid]] > u_lvl):
        raise ValueError("a tile update reads a row that is solved at a later level")
    d_lvl = solve_level[dest]
    if np.any((d_lvl >= 0) & (d_lvl <= u_lvl)):
        raise ValueError("a row receives a tile update at or after its own level")
    return dict(slot=slot, rows=rows, solve_level=solve_level, slot_of_row=slot_of_row,
                pos=pos, tid=tid, dest=dest, u_lvl=u_lvl, d_lvl=d_lvl)


def _pull_order(seg, off, wid, sr, ut, trow, tcol, n_rows: int, stp=None) -> dict:
    """The pull order of one launch, from host copies of the tables (see
    :func:`superstep_table`, which raises what this raises)."""
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
    u = _updates(off, wid, sr, ut, trow, tcol, n_rows, levels)
    slot, solve_level, slot_of_row = u["slot"], u["solve_level"], u["slot_of_row"]
    pos, tid, dest, d_lvl = u["pos"], u["tid"], u["dest"], u["d_lvl"]

    S = sr.shape[0]
    orphan_row = np.unique(dest[d_lvl < 0])
    target = np.where(d_lvl >= 0, slot_of_row[dest], S + np.searchsorted(orphan_row, dest))
    order = np.argsort(target, kind="stable")  # keeps the reference's order per target
    pull_ptr = np.zeros(S + orphan_row.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(target, minlength=S + orphan_row.shape[0]), out=pull_ptr[1:])
    return dict(levels=(t_lo, t_hi), S=S, live_slot=slot, pull_ptr=pull_ptr,
                pull_tile=tid[order], pull_col=tcol[tid[order]],
                pull_wait=solve_level[tcol[tid[order]]] >= 0, pull_pos=pos[order],
                pull_target=target[order], orphan_row=orphan_row,
                copy_row=np.nonzero(solve_level < 0)[0],
                widest=int(wid[levels, 0].max()) if levels.size else 0)


def superstep_table(seg, off, wid, sr, ut, trow, tcol, n_rows: int,
                    stp=None) -> SuperstepTable:
    """Build the pull table of one launch from host copies of the tables.

    Raises ``ValueError`` for tables the pull order cannot reproduce: a row
    solved twice, an update into a row at or after the row's own level, or
    an update that reads a row solved at a later level. Plans from
    ``core.solver.build_plan`` have none of them.
    """
    return _table(_pull_order(seg, off, wid, sr, ut, trow, tcol, n_rows, stp))


def _table(o: dict) -> SuperstepTable:
    n_orphans = int(o["orphan_row"].shape[0])
    return SuperstepTable(
        levels=o["levels"], pull_ptr=o["pull_ptr"].astype(np.int32),
        pull_tile=o["pull_tile"].astype(np.int32), pull_col=o["pull_col"].astype(np.int32),
        pull_wait=o["pull_wait"].astype(np.int32), orphan_row=o["orphan_row"].astype(np.int32),
        copy_row=o["copy_row"].astype(np.int32), n_solve_slots=o["S"],
        n_orphans=n_orphans, n_copy=int(o["copy_row"].shape[0]),
        max_items=max(o["widest"], n_orphans))


# ---------------------------------------------------------------------------
# the streamed form: the launch's tiles in the order the kernel uses them
# ---------------------------------------------------------------------------


def stream_tile_floats(B: int) -> int:
    """Floats one tile takes in the streamed store: ``B`` rows of ``B + 1``
    floats (the padding keeps a lane per row off one shared-memory bank),
    rounded up to a multiple of four, so every tile starts 16-byte aligned
    and every bulk copy moves a multiple of 16 bytes, odd ``B`` included."""
    return -(-B * (B + 1) // 4) * 4


def stage_floats(B: int, cap: int, rows: int) -> int:
    """Floats of one stage of the streamed kernel: ``cap`` whole store
    entries, or, where a stage holds fewer than ``B`` tile rows (``rows <
    B``, one entry in chunks), ``rows`` rows of ``B + 1`` floats."""
    return cap * stream_tile_floats(B) if rows >= B else rows * (B + 1)


def _streamed_bytes(warps: int, cap: int, rows: int, B: int) -> int:
    # per warp: two 8-byte mbarriers, two stages, the row's sum and two
    # source columns (B floats each); in row chunks once for the CTA, whose
    # warps share them, with CHUNK_STAGES stages and their mbarriers (16-byte
    # aligned); csrc/superstep.cu lays the CTA out in this order
    if rows < B:
        bars = -(-8 * CHUNK_STAGES // 16) * 16
        return bars + CHUNK_STAGES * 4 * stage_floats(B, cap, rows) + 12 * B
    return warps * (16 + 2 * 4 * stage_floats(B, cap, rows) + 12 * B)


def chunk_warps(B: int) -> int:
    """Warps of the CTA that runs each work item where tiles arrive in row
    chunks: one per 32 tile rows, at most ``WARPS_PER_CTA``."""
    return min(WARPS_PER_CTA, -(-B // 32))


def streamed_shape(B: int, max_item_tiles: int) -> tuple[int, int, int]:
    """``(warps per CTA, entries per stage, tile rows per stage)`` of the
    streamed kernel.

    Each warp double-buffers whole work items (a solve slot's incoming
    tiles and its diagonal tile) when eight, four, two or one warps of them
    fit ``SHARED_LIMIT``; else one warp streams its items in chunks of as
    many whole tiles as fit. Where two stages of one whole tile do not fit
    (``B >= 170``), each tile arrives in row chunks and one CTA of
    :func:`chunk_warps` warps runs each work item, the warps sharing one
    ring of ``CHUNK_STAGES`` stages and one set of columns: a stage holds
    ``rows`` padded tile rows, a multiple of four at most one a thread, for
    as few chunks a tile as fit, evened out (88 rows at B = 176 and 256), so
    every chunk starts ``i0 (B + 1) 4`` bytes into its entry, a
    multiple of 16 for odd and even ``B``; a tile's last chunk runs to the
    entry's padded end (:func:`stream_tile_floats`), a multiple of 16 bytes
    too. ``rows == B`` means whole tiles."""
    need = max(1, int(max_item_tiles))
    for warps in (8, 4, 2, 1):
        if _streamed_bytes(warps, need, B, B) <= SHARED_LIMIT:
            return warps, need, B
    if _streamed_bytes(1, 1, B, B) <= SHARED_LIMIT:
        cap = (SHARED_LIMIT - _streamed_bytes(1, 0, B, B)) // (8 * stream_tile_floats(B))
        return 1, min(cap, need), B
    most = (SHARED_LIMIT - _streamed_bytes(1, 0, 0, B)) // (4 * CHUNK_STAGES * (B + 1)) // 4 * 4
    per_chunk = -(-B // -(-B // most))  # as few chunks as fit, of rows as even as can be
    return chunk_warps(B), 1, -(-per_chunk // 4) * 4


def stream_chunks(B: int, rows: int) -> list[tuple[int, int]]:
    """The ``[from, to)`` float ranges of one store entry that the streamed
    kernel copies one after another with ``rows`` tile rows per stage: the
    whole entry when ``rows >= B``, else ``rows`` padded rows at a time, the
    last chunk to the entry's padded end."""
    if rows >= B:
        return [(0, stream_tile_floats(B))]
    return [(i0 * (B + 1), stream_tile_floats(B) if i0 + rows >= B else (i0 + rows) * (B + 1))
            for i0 in range(0, B, rows)]


def streamed_shared_bytes(B: int, max_item_tiles: int) -> int:
    """Dynamic shared memory of one streamed-kernel CTA: the single source
    of ``core.solver.fused_vmem_bytes(streamed=True)``. It fits
    ``SHARED_LIMIT`` at every ``B`` the kernel takes (:func:`check_streamed_fits`)."""
    return _streamed_bytes(*streamed_shape(B, max_item_tiles), B)


def check_streamed_fits(B: int) -> None:
    """Raise unless the streamed kernel takes block size ``B``: ``B < 1056``,
    the range of the resident form (whose stage holds one padded tile row
    of at most ``STAGE_FLOATS`` floats); both forms take the same blocks.
    Below that, :func:`streamed_shape` always finds a CTA that fits."""
    if B + 1 > STAGE_FLOATS:
        raise ValueError(f"streamed superstep: block size B={B} is over the megakernel's "
                         f"B < {STAGE_FLOATS} (one padded tile row of a resident stage)")


@dataclasses.dataclass(frozen=True)
class StreamedLayout:
    """Where the streamed store keeps each tile of one launch.

    Entries are whole tiles in the order the kernel uses them: for each
    target (solve slot ``k``, then orphan ``q``) its incoming tiles in pull
    order, then, for a slot, its diagonal tile (the identity for a pad
    slot). Target ``k`` so holds entries ``[pull_ptr[k] + min(k, S),
    pull_ptr[k+1] + min(k+1, S))``, and a level's slots are one contiguous
    run. ``source[e]`` is the row of ``cat(diag, tiles)`` entry ``e`` holds;
    ``diag_entry[k]`` the entry of slot ``k``'s diagonal tile;
    ``tile_entry[j]`` the entry of the tile at flat update position ``j``
    (``-1``: outside the launch, or an update into the pad row).
    ``max_item_tiles`` is the most entries of one work item and
    ``copied_entries`` the entries the kernel copies for one right-hand-side
    column (pad slots are never copied).
    """

    table: SuperstepTable
    source: np.ndarray | torch.Tensor
    diag_entry: np.ndarray | torch.Tensor
    tile_entry: np.ndarray | torch.Tensor
    max_item_tiles: int
    copied_entries: int

    def to(self, device) -> "StreamedLayout":
        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        return dataclasses.replace(self, table=self.table.to(device), source=dev(self.source),
                                   diag_entry=dev(self.diag_entry),
                                   tile_entry=dev(self.tile_entry))


def streamed_layout(seg, off, wid, sr, ut, trow, tcol, n_rows: int,
                    stp=None) -> StreamedLayout:
    """The pull table and the streamed store's layout of one launch, from
    host copies of the tables; built once per plan."""
    o = _pull_order(seg, off, wid, sr, ut, trow, tcol, n_rows, stp)
    n_orphans = int(o["orphan_row"].shape[0])
    table = _table(o)
    S, pull_ptr = o["S"], o["pull_ptr"]
    sr = np.asarray(sr, np.int64)
    n_targets = S + n_orphans
    per_target = np.diff(pull_ptr) + (np.arange(n_targets) < S)
    diag_entry = pull_ptr[1:S + 1] + np.arange(S)
    pull_entry = np.arange(pull_ptr[-1]) + np.minimum(o["pull_target"], S)
    # a store with no entry holds one identity tile, so every pointer is valid
    source = np.full(max(1, int(per_target.sum())), n_rows - 1, np.int64)
    source[diag_entry] = np.where(sr < 0, n_rows - 1, sr)
    source[pull_entry] = n_rows + o["pull_tile"]
    tile_entry = np.full(np.asarray(ut).shape[0], -1, np.int64)
    tile_entry[o["pull_pos"]] = pull_entry
    live = np.concatenate([np.isin(np.arange(S), o["live_slot"]), np.ones(n_orphans, bool)])
    return StreamedLayout(
        table=table, source=source, diag_entry=diag_entry, tile_entry=tile_entry,
        max_item_tiles=int(per_target[live].max()) if live.any() else 0,
        copied_entries=int(per_target[live].sum()))


def streamed_values(layout: StreamedLayout, diag: torch.Tensor,
                    tiles: torch.Tensor) -> torch.Tensor:
    """The streamed store: ``(entries, stream_tile_floats(B))`` float32 on
    the stores' device, entry ``e`` holding tile ``source[e]`` of
    ``cat(diag, tiles)`` with rows padded to ``B + 1`` floats (the padding
    is zero). Rebuilt whenever the values change."""
    B = diag.shape[1]
    src = torch.cat([diag, tiles])[torch.as_tensor(layout.source, device=diag.device)]
    values = torch.zeros(src.shape[0], stream_tile_floats(B), dtype=diag.dtype,
                         device=diag.device)
    values[:, :B * (B + 1)].view(-1, B, B + 1)[:, :, :B] = src
    return values


# ---------------------------------------------------------------------------
# a solve in several launches: the unified executor's, one per superstep
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SegmentedLayout:
    """The pull tables and the streamed store of a solve made of several
    launches, built once per device from one pull order.

    The multi-device unified executor launches once per superstep and
    exchanges between launches, so each launch pulls only the updates its
    own levels source: into the rows it solves (its solve slots) and, as
    orphans, into every other row (rows solved by a later launch or owned by
    another device). Every live tile update of the schedule so belongs to
    exactly one launch, and the launches' tables are consecutive slices of
    one set of arrays: ``segments[l]`` is a :class:`SuperstepTable` view of
    launch ``l`` (``ptr_at``/``orphan_at`` into the shared ``pull_ptr`` and
    ``orphan_row``), in the reference's push order per target. The streamed
    store holds, launch after launch, each solve slot's incoming tiles and
    its diagonal tile, then each orphan's tiles, so the kernel's entry rule
    (target ``k`` from ``pull_ptr[k] + min(k, S)``) holds in every launch.
    ``source``, ``diag_entry``, ``tile_entry``, ``max_item_tiles`` and
    ``copied_entries`` are as in :class:`StreamedLayout`, over the whole
    solve (``max_item_tiles`` sizes every launch alike). Host work and
    table size are O(rows + schedule) per device, once, not per launch.
    """

    segments: tuple
    source: np.ndarray | torch.Tensor
    diag_entry: np.ndarray | torch.Tensor
    tile_entry: np.ndarray | torch.Tensor
    max_item_tiles: int
    copied_entries: int

    def to(self, device) -> "SegmentedLayout":
        """Every array on ``device``, each moved once (the segments keep
        sharing them)."""
        def dev(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        views = ()
        if self.segments:
            flat = self.segments[0].to(device)
            views = tuple(dataclasses.replace(
                seg, pull_ptr=flat.pull_ptr, pull_tile=flat.pull_tile,
                pull_col=flat.pull_col, pull_wait=flat.pull_wait,
                orphan_row=flat.orphan_row, copy_row=flat.copy_row)
                for seg in self.segments)
        return dataclasses.replace(self, segments=views, source=dev(self.source),
                                   diag_entry=dev(self.diag_entry),
                                   tile_entry=dev(self.tile_entry))


def segmented_layout(off, wid, sr, ut, trow, tcol, n_rows: int, stp=None, *,
                     bounds) -> SegmentedLayout:
    """The launches ``bounds[l] <= s < bounds[l+1]`` (superstep offsets,
    increasing from 0) of one solve, from host copies of the reference's
    tables, whose level slices must lie end to end from slot 0 (as a plan's
    do). Raises what :func:`superstep_table` raises, for the solve as a
    whole: a row solved twice, an update that reads a row solved at a later
    level, or one into a row at or after that row's level."""
    off, wid, sr, ut, trow, tcol = (np.asarray(v, np.int64)
                                    for v in (off, wid, sr, ut, trow, tcol))
    T = off.shape[0]
    stp = np.arange(T + 1) if stp is None else np.asarray(stp, np.int64)
    bounds = np.asarray(bounds, np.int64)
    if (bounds.ndim != 1 or bounds.size < 1 or bounds[0] != 0 or np.any(np.diff(bounds) < 0)
            or bounds[-1] >= stp.shape[0]):
        raise ValueError(f"launch bounds {bounds.tolist()} are not supersteps increasing "
                         f"from 0 of the {stp.shape[0] - 1}")
    slot_at = (np.concatenate([off[:, 0], off[-1:, 0] + wid[-1:, 0]]) if T
               else np.zeros(1, np.int64))
    if T and (off[0, 0] != 0 or np.any(np.diff(slot_at) != wid[:, 0])):
        raise ValueError("segmented tables need the levels' solve slices end to end from 0")
    n_launch = bounds.shape[0] - 1
    lvl_b = stp[bounds] if T else np.zeros(n_launch + 1, np.int64)
    sb = slot_at[lvl_b]  # each launch's first solve slot, then the end
    launch_of = np.searchsorted(lvl_b, np.arange(T), side="right") - 1
    u = _updates(off, wid, sr, ut, trow, tcol, n_rows, np.arange(lvl_b[-1]))
    tid, dest, d_lvl = u["tid"], u["dest"], u["d_lvl"]
    l_u = launch_of[u["u_lvl"]]
    to_slot = (d_lvl >= 0) & (launch_of[np.maximum(d_lvl, 0)] == l_u)
    key = l_u * n_rows + dest  # an orphan is a row the launch updates but does not solve
    orphan_key = np.unique(key[~to_slot])
    n_orph = np.bincount(orphan_key // n_rows, minlength=n_launch)
    orph_first = np.cumsum(n_orph) - n_orph
    n_slots = np.diff(sb)
    block = n_slots + n_orph + 1  # each launch's pointers: its slots, its orphans, the end
    block_at = np.cumsum(block) - block
    target = np.where(to_slot, block_at[l_u] + u["slot_of_row"][dest] - sb[l_u],
                      block_at[l_u] + n_slots[l_u]
                      + np.searchsorted(orphan_key, key) - orph_first[l_u])
    cnt = np.bincount(target, minlength=int(block.sum()))
    pull_ptr = np.cumsum(cnt) - cnt
    order = np.argsort(target, kind="stable")  # keeps the reference's order per target
    src_lvl = u["solve_level"][tcol[tid]]
    wait = (src_lvl >= 0) & (launch_of[np.maximum(src_lvl, 0)] == l_u)
    pull_tile, pull_target = tid[order], target[order]

    # the streamed store: a slot's pulls follow the diagonal entries of
    # every earlier slot; launch l's orphans those of all its slots too
    tgt_launch = np.searchsorted(block_at, pull_target, side="right") - 1
    local = pull_target - block_at[tgt_launch]
    pull_entry = np.arange(order.shape[0]) + np.where(
        local < n_slots[tgt_launch], sb[tgt_launch] + local, sb[tgt_launch + 1])
    slots = np.arange(sb[-1])
    slot_ptr = slots + (block_at - sb[:-1])[np.searchsorted(sb, slots, side="right") - 1]
    diag_entry = pull_ptr[slot_ptr] + cnt[slot_ptr] + slots
    live_sr = sr[:sb[-1]]
    source = np.full(max(1, order.shape[0] + int(sb[-1])), n_rows - 1, np.int64)
    source[diag_entry] = np.where(live_sr < 0, n_rows - 1, live_sr)
    source[pull_entry] = n_rows + pull_tile
    tile_entry = np.full(ut.shape[0], -1, np.int64)
    tile_entry[u["pos"][order]] = pull_entry
    orphan_ptr, _ = _ranges(block_at + n_slots, n_orph)
    items = np.concatenate([cnt[slot_ptr][live_sr >= 0] + 1, cnt[orphan_ptr]])

    flat = SuperstepTable(
        levels=(0, 0), pull_ptr=pull_ptr.astype(np.int32), pull_tile=pull_tile.astype(np.int32),
        pull_col=tcol[pull_tile].astype(np.int32), pull_wait=wait[order].astype(np.int32),
        orphan_row=(orphan_key % n_rows).astype(np.int32), copy_row=np.zeros(0, np.int32),
        n_solve_slots=0, n_orphans=0, n_copy=0, max_items=0)
    segments = tuple(dataclasses.replace(
        flat, levels=(int(lvl_b[l]), int(lvl_b[l + 1])), n_solve_slots=int(sb[l + 1]),
        n_orphans=int(n_orph[l]),
        max_items=max(int(wid[lvl_b[l]:lvl_b[l + 1], 0].max(initial=0)), int(n_orph[l])),
        ptr_at=int(block_at[l] - sb[l]), orphan_at=int(orph_first[l])) for l in range(n_launch))
    return SegmentedLayout(segments=segments, source=source, diag_entry=diag_entry,
                           tile_entry=tile_entry, max_item_tiles=int(items.max(initial=0)),
                           copied_entries=int(items.sum()))


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


def _check_flags(fn: str, flags: ReadyFlags, n_rows: int, device) -> None:
    if not isinstance(flags, ReadyFlags):
        raise TypeError(f"{fn}: flags must be a ReadyFlags, got {type(flags).__name__}")
    same = (flags.device.type == device.type
            and None in (flags.device.index, device.index) or flags.device == device)
    if flags.n_rows != n_rows or not same:
        raise ValueError(f"{fn}: flags for {flags.n_rows} rows on {flags.device}, the "
                         f"operands have {n_rows} rows on {device}")


def _check_split(fn: str, acc, delta, x) -> None:
    """The split form's third carry: like ``acc``, and no two carries in
    one buffer (the kernel reads ``acc`` and writes ``delta`` and ``x``)."""
    if delta.dtype != torch.float32 or delta.shape != acc.shape or delta.device != acc.device:
        raise ValueError(f"{fn}: delta must be float32 {tuple(acc.shape)} on {acc.device}, got "
                         f"{delta.dtype} {tuple(delta.shape)} on {delta.device}")
    if not delta.is_contiguous():
        raise ValueError(f"{fn}: operands must be contiguous")
    ptrs = {v.untyped_storage().data_ptr() for v in (acc, delta, x)}
    if len(ptrs) != 3:
        raise ValueError(f"{fn}: acc, delta and x must be three tensors of their own")


def _at(t: torch.Tensor, k: int) -> int:
    """The device address of element ``k`` of ``t``."""
    return t.data_ptr() + k * t.element_size()


def superstep_call(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad, acc, x,
                   stp=None, *, grid: int = 0, table: SuperstepTable | None = None,
                   flags: ReadyFlags, delta=None):
    """Run supersteps ``seg[0] .. seg[0] + seg[1] - 1`` of the schedule in
    one launch; returns new ``(acc, x)``, leaving the carries passed in as
    they were. With a ``delta`` carry, the split form (the reference's
    ``split_delta=True``, :func:`superstep_split_` on copies of the carries):
    returns new ``(acc, delta, x)``.

    The tables are the reference's (``kernels/superstep.py::superstep_call``
    in the JAX package), as int32 tensors on the operands' device; ``stp``
    ``None`` means one level per superstep. Unlike the reference, ``grid`` is
    the number of CTAs (0: enough for the widest level, at most what fits on
    the card at once; more than fits is refused, and raises), not a program
    per superstep: every superstep of ``seg`` runs. ``table`` is
    :func:`superstep_table` of the same tables, already on the device; when
    it is ``None`` the wrapper builds it from host copies. ``flags`` is the
    caller's :class:`ReadyFlags` for ``diag.shape[0]`` rows on the operands'
    device, kept from launch to launch (the plain version on the CPU does
    not touch it). A launch with no level makes no kernel launch.
    """
    if delta is not None:
        acc_out, delta_out, x_out = acc.clone(), delta.clone(), x.clone()
        return superstep_split_(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad, acc_out,
                                delta_out, x_out, stp, grid=grid, table=table, flags=flags)
    tables = tuple(t for t in (seg, off, wid, sr, ut, trow, tcol, stp) if t is not None)
    _check(diag, tiles, b_pad, acc, x, tables)
    _check_flags("superstep_call", flags, diag.shape[0], diag.device)
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
    ready, epoch = flags.next(R)
    ptrs = [t.data_ptr() for t in (off, wid, sr, table.pull_ptr, table.pull_tile,
                                   table.pull_col, table.pull_wait, table.orphan_row,
                                   table.copy_row, diag, tiles, b_pad, acc, x, acc_out, x_out,
                                   ready)]
    sizes = [t_lo, t_hi, B] + ([] if R == 1 else [R]) + [
        table.n_solve_slots, table.n_orphans, table.n_copy, table.max_items, grid, epoch]
    fn = "repro_superstep_f32" if R == 1 else "repro_superstep_panel_f32"
    extension.launch("superstep", fn, diag.device, *ptrs, *sizes)
    superstep_call.launches += 1
    return acc_out, x_out


superstep_call.launches = 0


def superstep_split_(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad, acc, delta, x,
                     stp=None, *, grid: int = 0, table: SuperstepTable | None = None,
                     flags: ReadyFlags):
    """The split form of :func:`superstep_call`, in place: supersteps
    ``seg[0] .. seg[0] + seg[1] - 1`` with the tile updates summed into
    ``delta`` and each row solved with ``rhs = (b - acc) - delta``; ``acc``
    is only read. ``delta`` and ``x`` are updated where they lie (the rows
    the launch solves, the rows it pulls into), nothing else is written, and
    the three carries are returned. They must be three tensors of their
    own. This is the unified executor's launch, one per superstep, with the
    exchange between launches (``core/solver.py``).

    ``table`` is :func:`superstep_table` of the launch, or one of the
    ``segments`` of a :class:`SegmentedLayout`; ``None`` builds the first
    from host copies. On the card, one cooperative launch of the split
    entry point, counted in ``superstep_split_.launches``; given CPU
    tensors, the plain version (:func:`repro_torch.kernels.ref.superstep_ref`
    with ``delta``), its result copied into the carries.
    """
    tables = tuple(t for t in (seg, off, wid, sr, ut, trow, tcol, stp) if t is not None)
    _check(diag, tiles, b_pad, acc, x, tables)
    _check_split("superstep_split_", acc, delta, x)
    _check_flags("superstep_split_", flags, diag.shape[0], diag.device)
    if diag.device.type == "cpu":
        _, d, xs = ref.superstep_ref(seg, off, wid, sr, ut, trow, tcol, diag, tiles, b_pad,
                                     acc, x, stp, delta=delta)
        delta.copy_(d)
        x.copy_(xs)
        return acc, delta, x
    if table is None:
        host = [t.cpu().numpy() for t in (seg, off, wid, sr, ut, trow, tcol)]
        table = superstep_table(*host, n_rows=diag.shape[0],
                                stp=None if stp is None else stp.cpu().numpy()).to(diag.device)
    t_lo, t_hi = table.levels
    if t_hi == t_lo:
        return acc, delta, x
    B = diag.shape[1]
    R = 1 if b_pad.ndim == 2 else b_pad.shape[2]
    ready, epoch = flags.next(R)
    ptrs = [t.data_ptr() for t in (off, wid, sr)]
    ptrs += [_at(table.pull_ptr, table.ptr_at)]
    ptrs += [t.data_ptr() for t in (table.pull_tile, table.pull_col, table.pull_wait)]
    ptrs += [_at(table.orphan_row, table.orphan_at)]
    ptrs += [t.data_ptr() for t in (diag, tiles, b_pad, acc, delta, x, ready)]
    sizes = [t_lo, t_hi, B, R, table.n_solve_slots, table.n_orphans, table.max_items, grid,
             epoch]
    extension.launch("superstep", "repro_superstep_split_f32", diag.device, *ptrs, *sizes)
    superstep_split_.launches += 1
    return acc, delta, x


superstep_split_.launches = 0


def _check_streamed(values, b_pad, acc, x, tables, layout, table: SuperstepTable) -> None:
    vecs = (values, b_pad, acc, x)
    if any(v.dtype != torch.float32 for v in vecs):
        raise TypeError("superstep_streamed_call: float32 values, b_pad, acc and x required")
    if any(t.dtype != torch.int32 for t in tables):
        raise TypeError("superstep_streamed_call: int32 schedule tables required")
    devices = {v.device for v in vecs + tables}
    if len(devices) != 1:
        raise ValueError(f"superstep_streamed_call: operands on several devices "
                         f"{sorted(map(str, devices))}")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"superstep_streamed_call: unsupported device {values.device}")
    if b_pad.ndim not in (2, 3) or acc.shape != b_pad.shape or x.shape != b_pad.shape:
        raise ValueError(f"superstep_streamed_call: b_pad, acc, x must be (nb+1,B[,R]), got "
                         f"{tuple(b_pad.shape)}, {tuple(acc.shape)}, {tuple(x.shape)}")
    B = b_pad.shape[1]
    n_entries = layout.source.shape[0]
    if values.shape != (n_entries, stream_tile_floats(B)):
        raise ValueError(f"superstep_streamed_call: values must be ({n_entries}, "
                         f"{stream_tile_floats(B)}) for this layout at B={B}, got "
                         f"{tuple(values.shape)}")
    if not all(v.is_contiguous() for v in vecs + tables):
        raise ValueError("superstep_streamed_call: operands must be contiguous")
    if values.device.type == "cuda" and any(
            not isinstance(t, torch.Tensor) or t.device != values.device
            for t in (table.pull_ptr, table.pull_col, table.pull_wait, table.orphan_row,
                      table.copy_row)):
        raise ValueError("superstep_streamed_call: layout must be on the operands' device "
                         "(StreamedLayout.to)")
    check_streamed_fits(B)


def superstep_streamed_call(seg, off, wid, sr, ut, trow, tcol, values, b_pad, acc, x,
                            stp=None, *, layout: StreamedLayout, grid: int = 0,
                            flags: ReadyFlags, delta=None):
    """:func:`superstep_call` with the streamed store: the same function of
    the same tables, with every tile read from ``values``
    (:func:`streamed_values` of ``layout``, the launch's
    :func:`streamed_layout`) instead of ``diag``/``tiles``. On a card, one
    cooperative launch of the streamed kernel, which copies each work
    item's tiles (at ``B >= 170`` each tile in row chunks, one CTA an item,
    :func:`streamed_shape`, and by default four CTAs for each item of the
    widest level, the items dealt round them) into shared memory with asynchronous bulk
    copies issued one chunk ahead; given CPU tensors, the plain version
    (:func:`repro_torch.kernels.ref.superstep_streamed_ref`). ``layout`` must
    be on the operands' device for a launch; ``flags`` as for
    :func:`superstep_call`, for ``b_pad.shape[0]`` rows. Raises for a block
    size the kernel does not take (:func:`check_streamed_fits`). With a
    ``delta`` carry, the split form (:func:`superstep_streamed_split_` on
    copies of the carries), which returns new ``(acc, delta, x)``."""
    if delta is not None:
        acc_out, delta_out, x_out = acc.clone(), delta.clone(), x.clone()
        return superstep_streamed_split_(seg, off, wid, sr, ut, trow, tcol, values, b_pad,
                                         acc_out, delta_out, x_out, stp, layout=layout,
                                         grid=grid, flags=flags)
    tables = tuple(t for t in (seg, off, wid, sr, ut, trow, tcol, stp) if t is not None)
    _check_streamed(values, b_pad, acc, x, tables, layout, layout.table)
    _check_flags("superstep_streamed_call", flags, b_pad.shape[0], values.device)
    if values.device.type == "cpu":
        return ref.superstep_streamed_ref(
            seg, off, wid, sr, ut, trow, tcol, values, torch.as_tensor(layout.diag_entry),
            torch.as_tensor(layout.tile_entry), b_pad, acc, x, stp)
    table = layout.table
    t_lo, t_hi = table.levels
    if t_hi == t_lo:
        return acc.clone(), x.clone()
    acc_out, x_out = torch.empty_like(acc), torch.empty_like(x)
    B = b_pad.shape[1]
    R = 1 if b_pad.ndim == 2 else b_pad.shape[2]
    warps, cap, rows = streamed_shape(B, layout.max_item_tiles)
    ready, epoch = flags.next(R)
    ptrs = [t.data_ptr() for t in (off, wid, sr, table.pull_ptr, table.pull_col,
                                   table.pull_wait, table.orphan_row, table.copy_row, values,
                                   b_pad, acc, x, acc_out, x_out, ready)]
    sizes = [t_lo, t_hi, B, R, table.n_solve_slots, table.n_orphans, table.n_copy,
             table.max_items, grid, warps, cap, rows, epoch]
    extension.launch("superstep", "repro_superstep_streamed_f32", values.device, *ptrs, *sizes)
    superstep_streamed_call.launches += 1
    return acc_out, x_out


superstep_streamed_call.launches = 0


def superstep_streamed_split_(seg, off, wid, sr, ut, trow, tcol, values, b_pad, acc, delta, x,
                              stp=None, *, layout, table: SuperstepTable | None = None,
                              grid: int = 0, flags: ReadyFlags):
    """:func:`superstep_split_` with the streamed store: ``values`` is
    :func:`streamed_values` of ``layout``, a :class:`StreamedLayout` of the
    launch (``table`` then defaults to its own) or a :class:`SegmentedLayout`
    of the whole solve with ``table`` one of its ``segments``. In place, as
    there; on the card one launch of the streamed split entry point, counted
    in ``superstep_streamed_split_.launches``; given CPU tensors, the plain
    version (:func:`repro_torch.kernels.ref.superstep_streamed_ref` with
    ``delta``)."""
    table = layout.table if table is None else table
    tables = tuple(t for t in (seg, off, wid, sr, ut, trow, tcol, stp) if t is not None)
    _check_streamed(values, b_pad, acc, x, tables, layout, table)
    _check_split("superstep_streamed_split_", acc, delta, x)
    _check_flags("superstep_streamed_split_", flags, b_pad.shape[0], values.device)
    if values.device.type == "cpu":
        _, d, xs = ref.superstep_streamed_ref(
            seg, off, wid, sr, ut, trow, tcol, values, torch.as_tensor(layout.diag_entry),
            torch.as_tensor(layout.tile_entry), b_pad, acc, x, stp, delta=delta)
        delta.copy_(d)
        x.copy_(xs)
        return acc, delta, x
    t_lo, t_hi = table.levels
    if t_hi == t_lo:
        return acc, delta, x
    B = b_pad.shape[1]
    R = 1 if b_pad.ndim == 2 else b_pad.shape[2]
    warps, cap, rows = streamed_shape(B, layout.max_item_tiles)
    ready, epoch = flags.next(R)
    ptrs = [t.data_ptr() for t in (off, wid, sr)]
    ptrs += [_at(table.pull_ptr, table.ptr_at), table.pull_col.data_ptr(),
             table.pull_wait.data_ptr(), _at(table.orphan_row, table.orphan_at)]
    ptrs += [t.data_ptr() for t in (values, b_pad, acc, delta, x, ready)]
    sizes = [t_lo, t_hi, B, R, table.n_solve_slots, table.n_orphans, table.max_items, grid,
             warps, cap, rows, epoch]
    extension.launch("superstep", "repro_superstep_streamed_split_f32", values.device, *ptrs,
                     *sizes)
    superstep_streamed_split_.launches += 1
    return acc, delta, x


superstep_streamed_split_.launches = 0
