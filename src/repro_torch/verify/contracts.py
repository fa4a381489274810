"""Kernel-contract lint: static invariants of the port's executors and
megakernels.

Where ``happens_before`` proves the *schedule* is a legal linearization of
the dependency DAG, this module proves the *encoding* of that schedule
matches what the port's kernels assume about it. Every check is against a
re-derivation from the plan's own arrays (pattern, partition, offsets),
never against the output it checks.

The rule ids are the reference package's (``repro.verify.contracts``).
Where the port's Hopper kernel differs from the TPU kernel a rule was
written for, the rule checks the port's contract instead (marked *port*
below); ``kc.pull.wait`` is the port's own.

Rule catalogue (``kc.*``; all errors):

* ``kc.offsets.cumsum`` — ``lvl_off`` columns are exactly the exclusive
  cumulative sum of the per-level bucket widths (monotonicity follows).
  The executors slice the flats at these offsets; a broken table reads
  wrong-but-in-bounds schedule entries, silently.
* ``kc.flats.length`` — each flat array is exactly ``max(1, sum(widths))``
  long (the executors' slice arithmetic assumes no tail gap).
* ``kc.buckets.fit`` — at most ``MAX_BUCKETS`` buckets and every
  ``lvl_bucket`` entry indexes one.
* ``kc.buckets.cover`` — every level's bucket width covers the rows/tiles/
  exchanges actually scheduled at that level on the busiest device
  (an undershooting bucket truncates the level).
* ``kc.stream.ladder`` — the static width ladders
  (``core.solver.stream_widths``) are exactly the distinct per-superstep
  widths of the schedule (``streamed_stores`` is laid out by them).
* ``kc.stream.slices`` (*port*) — the per-level slices of the flats, which
  the megakernels walk through ``lvl_off``, are disjoint and exactly cover
  ``[0, sum(widths))`` within the flat; and the streamed store's layout
  (``kernels.superstep.streamed_layout``, one per device) is a partition:
  every store entry belongs to exactly one work item, each target's entries
  form one contiguous run (its incoming tiles, then its diagonal tile), and
  ``diag_entry``/``tile_entry`` name every entry exactly once, covering
  each live solve slot and each in-launch update once. The Hopper kernel
  copies whole work items with bulk copies, not level-slice DMA bursts; an
  entry claimed twice feeds one row another row's tile.
* ``kc.stream.bytes`` (*port*) — ``stream_dma_bytes_per_solve(plan, R)``
  equals ``R x copied_entries x 4 x stream_tile_floats(B)`` with the copied
  entries (each live solve slot's diagonal tile and each in-launch update's
  tile) counted from the plan's slices, on the busiest device; and the
  bulk copies of one entry (``kernels.superstep.stream_chunks``: the whole
  entry, or at ``B >= 170`` chunks of ``rows`` padded tile rows) cover it
  once, each starting and ending on a 16-byte boundary and fitting a stage.
* ``kc.scratch.shape`` (*port*) — the shared memory a fused launch requests
  (``core.solver.fused_vmem_bytes``) is the kernel's rule: resident,
  ``kernels.superstep.shared_bytes(B)``; streamed,
  ``streamed_shared_bytes(B, max_item_tiles)`` with the widest work item
  counted from the plan's slices (row chunks where two stages of one whole
  tile do not fit: one CTA of ``chunk_warps(B)`` warps an item, sharing one
  pair of stages, at most one chunk row a thread); and each fits
  ``SHARED_LIMIT`` where the plan runs that form. Either form fails here at ``B >= 1056`` (one padded tile row over
  the resident stage; both forms take the same blocks).
* ``kc.carry.donation`` (*port*) — the megakernel wrappers
  (``superstep_call``, ``superstep_streamed_call``) and their plain
  versions return fresh ``acc``/``x`` (and, split, ``delta``) tensors and
  never write into the carries passed in: the fused executor passes one
  ``zeros`` tensor as both carries, so an in-place write to one would
  corrupt the other. Linted on the functions' source
  (:func:`carry_donation_findings`). The split form's in-place launchers
  (``superstep_split_``, ``superstep_streamed_split_``, the unified
  executor's) are not linted: they update their carries by design, and
  refuse carries that share a buffer when called.
* ``kc.pull.wait`` (*port*) — the resident kernel's pull table
  (``kernels.superstep.SuperstepTable``, one per device): ``pull_wait`` is 1
  exactly where the pulled tile's source row is solved in the launch (the
  kernel spins on that row's ready flag) and 0 where it is not (its ``x``
  is the carry passed in; a wait there would never end).
* ``kc.pad.inert`` — every pad sentinel is the inert value the kernels
  assume: identity diagonal at the pad row, zero tile at the pad slot,
  ``nb`` destinations, ``-1`` owner, zero in-degree.
* ``kc.segments.partition`` — fused segments partition ``[0, T)`` in order,
  and every level whose exchange bucket is non-empty *starts* a segment
  (a fused launch exchanges only at its start). For merged (``dagpart``)
  plans, every segment boundary must additionally sit on a superstep
  boundary.
* ``kc.steps.partition`` — when a merged step table (``plan.step_off``) is
  present it must partition ``[0, T)``: start at 0, increase strictly, end
  at T.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.verify.report import ERROR, RuleSink

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.core.solver import Plan


def _widths(plan: "Plan") -> np.ndarray:
    """(T, 3) per-level bucket widths, robust to corrupt bucket ids (flagged
    separately by ``kc.buckets.fit``)."""
    bid = np.clip(plan.lvl_bucket, 0, len(plan.buckets) - 1)
    return np.asarray(plan.buckets, dtype=np.int64)[bid]


def _valid_step_off(plan: "Plan") -> np.ndarray | None:
    """``plan.step_off`` as a validated int64 array (identity for unmerged
    plans), or ``None`` when the table cannot partition ``[0, T)`` —
    downstream checks must then skip step-granular derivations rather than
    cascade off bad data (``kc.steps.partition`` owns the finding)."""
    T = plan.n_levels
    if plan.step_off is None:
        return np.arange(T + 1, dtype=np.int64)
    so = np.asarray(plan.step_off, dtype=np.int64).ravel()
    if (so.size < 1 or int(so[0]) != 0 or int(so[-1]) != T
            or (so.size > 1 and np.any(np.diff(so) <= 0))):
        return None
    return so


def check_contracts(plan: "Plan", sink: RuleSink) -> None:
    _check_offsets(plan, sink)
    steps_ok = _check_steps(plan, sink)
    ids_ok = _check_buckets(plan, sink)
    _check_pad_inert(plan, sink)
    _check_donation(sink)
    # the segment/streaming helpers index `buckets` with `lvl_bucket`
    # unclamped (the builders guarantee validity); once kc.buckets.fit has
    # flagged a corrupt id — or kc.steps.partition a corrupt step table —
    # there is nothing sound left to derive from them
    if plan.config.sched in ("levelset", "dagpart") and ids_ok and steps_ok:
        _check_segments(plan, sink)
        _check_streaming(plan, sink)


def _check_steps(plan: "Plan", sink: RuleSink) -> bool:
    sink.check("kc.steps.partition")
    if plan.step_off is None:
        return True
    if _valid_step_off(plan) is None:
        so = np.asarray(plan.step_off).ravel()
        sink.fail(
            "kc.steps.partition",
            f"step_off {so.tolist()} does not partition [0, {plan.n_levels}) "
            "into merged supersteps (must start at 0, increase strictly, and "
            f"end at {plan.n_levels})",
        )
        return False
    return True


def _check_offsets(plan: "Plan", sink: RuleSink) -> None:
    sink.check("kc.offsets.cumsum")
    sink.check("kc.flats.length")
    wid = _widths(plan)
    T = plan.n_levels
    names = ("solve", "update", "exchange")
    flats = (plan.solve_rows.shape[1], plan.upd_tiles.shape[1],
             plan.ex_rows.shape[0])
    for col, name in enumerate(names):
        w = wid[:, col] if T else np.zeros(0, np.int64)
        expect = np.concatenate([[0], np.cumsum(w)[:-1]]) if T else w
        got = plan.lvl_off[:, col]
        if not np.array_equal(got, expect):
            t = int(np.nonzero(got != expect)[0][0])
            sink.fail(
                "kc.offsets.cumsum",
                f"{name} offsets are not the cumulative sum of the bucket "
                f"widths (first mismatch: lvl_off[{t}]={int(got[t])}, "
                f"expected {int(expect[t])})", level=t,
            )
        want_len = max(1, int(w.sum()))
        if flats[col] != want_len:
            sink.fail(
                "kc.flats.length",
                f"{name} flat has length {flats[col]}, schedule widths sum "
                f"to {want_len}",
            )


def _check_buckets(plan: "Plan", sink: RuleSink) -> bool:
    """Returns whether every ``lvl_bucket`` id is in range (downstream
    checks re-derive widths through the executors' own unclamped lookups)."""
    from repro_torch.core.solver import MAX_BUCKETS

    sink.check("kc.buckets.fit")
    sink.check("kc.buckets.cover")
    if len(plan.buckets) > MAX_BUCKETS:
        sink.fail("kc.buckets.fit",
                  f"{len(plan.buckets)} buckets exceed MAX_BUCKETS="
                  f"{MAX_BUCKETS}")
    bad = [t for t, b in enumerate(plan.lvl_bucket)
           if not 0 <= int(b) < len(plan.buckets)]
    for t in bad:
        sink.fail("kc.buckets.fit",
                  f"lvl_bucket[{t}]={int(plan.lvl_bucket[t])} indexes no "
                  "bucket", level=t)

    # required widths, re-derived from pattern + partition (level-set layout:
    # level t's slice holds block-level-t rows/tiles/boundary rows)
    bs, part, D = plan.bs, plan.part, plan.n_devices
    T = plan.n_levels
    if T == 0:
        return not bad
    lvl = np.asarray(bs.block_level, dtype=np.int64)
    owner = np.asarray(part.owner)
    wid = _widths(plan)
    need = np.zeros((T, 3), dtype=np.int64)
    for d in range(D):
        mine = owner == d
        if mine.any():
            cnt = np.bincount(lvl[mine], minlength=T)[:T]
            need[:, 0] = np.maximum(need[:, 0], cnt)
        tmine = owner[bs.off_cols] == d
        if tmine.any():
            cnt = np.bincount(lvl[bs.off_cols[tmine]], minlength=T)[:T]
            need[:, 1] = np.maximum(need[:, 1], cnt)
    b_rows = np.nonzero(part.boundary)[0]
    if b_rows.size:
        exn = np.bincount(lvl[b_rows], minlength=T)[:T]
        if plan.config.sched == "dagpart" and plan.step_off is not None:
            so = _valid_step_off(plan)
            if so is None:
                exn = np.zeros(T, dtype=np.int64)  # kc.steps owns the finding
            else:
                # the builder hoists each merge group's exchange rows into
                # the group's first micro-level: the need is per *group*,
                # carried entirely by its start level
                cs = np.concatenate([[0], np.cumsum(exn)])
                hoisted = np.zeros(T, dtype=np.int64)
                hoisted[so[:-1]] = cs[so[1:]] - cs[so[:-1]]
                exn = hoisted
        need[:, 2] = exn
    names = ("solve", "update", "exchange")
    for col, name in enumerate(names):
        short = np.nonzero(wid[:, col] < need[:, col])[0]
        for t in short[: 4]:
            sink.fail(
                "kc.buckets.cover",
                f"level {int(t)} {name} bucket width {int(wid[t, col])} "
                f"undershoots the {int(need[t, col])} entries scheduled "
                "there (the slice truncates the level)", level=int(t),
            )
    return not bad


def _check_pad_inert(plan: "Plan", sink: RuleSink) -> None:
    sink.check("kc.pad.inert")
    nb, B = plan.bs.nb, plan.bs.B
    if not np.array_equal(plan.diag[-1], np.eye(B, dtype=plan.diag.dtype)):
        sink.fail("kc.pad.inert",
                  "diag pad slot is not the identity (pad solves would "
                  "produce non-finite garbage)")
    if plan.tiles.size and np.any(plan.tiles[:, -1] != 0):
        sink.fail("kc.pad.inert",
                  "tile pad slot is not the zero tile (pad updates would "
                  "inject garbage into acc)")
    for name, arr, want in (("owner", plan.owner[-1:], -1),
                            ("indeg", plan.indeg[-1:], 0),
                            ("tile_row pad", plan.tile_row[:, -1], nb),
                            ("tile_col pad", plan.tile_col[:, -1], nb)):
        if np.any(np.asarray(arr) != want):
            sink.fail("kc.pad.inert",
                      f"{name} sentinel is not {want}")


# ---------------------------------------------------------------------------
# kc.carry.donation: a lint of the megakernel wrappers' source
# ---------------------------------------------------------------------------

CARRIES = ("acc", "delta", "x")  # delta: the split form's third carry
# calls whose result is a tensor of its own (never a view of an argument)
_FRESH_CALLS = ("empty_like", "zeros_like", "clone", "empty", "zeros")


def _carry_functions() -> dict:
    """``{"module.function": source}`` of every function the fused executor
    hands its carries to: the two launch wrappers and their plain versions."""
    from repro_torch.kernels import ref, superstep

    fns = (superstep.superstep_call, superstep.superstep_streamed_call,
           ref.superstep_ref, ref.superstep_streamed_ref)
    return {f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}": inspect.getsource(fn)
            for fn in fns}


def _is_fresh_call(node) -> bool:
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _FRESH_CALLS)


def _pairs(target, value):
    """``(name, value node)`` pairs an assignment binds (tuple unpacking
    matched element by element)."""
    if isinstance(target, ast.Name):
        return [(target.id, value)]
    if (isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple)
            and len(target.elts) == len(value.elts)):
        return [p for t, v in zip(target.elts, value.elts) for p in _pairs(t, v)]
    if isinstance(target, ast.Tuple):
        return [(t.id, None) for t in target.elts if isinstance(t, ast.Name)]
    return []


def _writes(node, names: set) -> list:
    """Writes into the tensors ``names`` hold, anywhere under ``node``: an
    in-place method (``acc.index_add_(...)``, ``x.zero_()``), a subscript
    store (``x[rows] = ...``), or an ``out=`` argument."""
    found = []
    for n in ast.walk(node):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and isinstance(n.func.value, ast.Name) and n.func.value.id in names
                and n.func.attr.endswith("_") and not n.func.attr.startswith("_")):
            found.append(f"{n.func.value.id}.{n.func.attr}(...) at line {n.lineno}")
        if isinstance(n, (ast.Assign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                for sub in ast.walk(t):
                    if (isinstance(sub, ast.Subscript) and isinstance(sub.value, ast.Name)
                            and sub.value.id in names):
                        found.append(f"{sub.value.id}[...] = at line {n.lineno}")
        if isinstance(n, ast.Call):
            for kw in n.keywords:
                if (kw.arg == "out" and isinstance(kw.value, ast.Name)
                        and kw.value.id in names):
                    found.append(f"out={kw.value.id} at line {n.lineno}")
    return found


def carry_donation_findings(sources: dict | None = None) -> list:
    """Messages for every way the functions in ``sources`` (``{name:
    source}``; default :func:`_carry_functions`) could hand back or write
    into a carry passed in (``acc``, ``delta``, ``x``).

    The statements of each function are read in order. A carry is *fresh*
    once it is rebound to a call that makes a new tensor (``.clone()``,
    ``torch.empty_like`` ...); before that, any in-place write to it is a
    finding. Every ``return`` must return fresh tensors: names bound to such
    calls, such calls themselves, or another function's result (the plain
    version, linted here too), never a carry as it came in.
    """
    sources = _carry_functions() if sources is None else sources
    out = []
    for name, src in sources.items():
        fn = ast.parse(textwrap.dedent(src)).body[0]
        fresh: set = set()
        stale = set(CARRIES)  # carries still aliasing the caller's tensors
        for stmt in fn.body:
            out += [f"{name} writes into the carry passed in: {w}"
                    for w in _writes(stmt, stale)]
            for n in ast.walk(stmt):
                if isinstance(n, ast.Assign):
                    for target in n.targets:
                        for bound, value in _pairs(target, n.value):
                            if value is not None and _is_fresh_call(value):
                                fresh.add(bound)
                                stale.discard(bound)
                            else:
                                fresh.discard(bound)
                if isinstance(n, ast.Return) and n.value is not None:
                    elts = n.value.elts if isinstance(n.value, ast.Tuple) else [n.value]
                    for e in elts:
                        if isinstance(e, ast.Name) and e.id not in fresh:
                            out.append(f"{name} returns {e.id!r}, which is not a fresh "
                                       f"tensor (line {n.lineno})")
    return out


@functools.cache
def _lint_once() -> tuple:
    """:func:`carry_donation_findings` of the functions as loaded (their
    source does not change while the process runs)."""
    return tuple(carry_donation_findings())


def _check_donation(sink: RuleSink) -> None:
    sink.check("kc.carry.donation")
    for msg in _lint_once():
        sink.fail("kc.carry.donation",
                  msg + " — the fused executor passes one zeros tensor as both "
                  "carries, so each must come back untouched")


def _check_segments(plan: "Plan", sink: RuleSink) -> None:
    from repro_torch.core.solver import fused_segments

    sink.check("kc.segments.partition")
    segs = np.asarray(fused_segments(plan))
    T = plan.n_levels
    if T == 0:
        if len(segs):
            sink.fail("kc.segments.partition",
                      "0-level plan has fused segments")
        return
    flat = []
    for lo, hi in segs:
        if hi <= lo:
            sink.fail("kc.segments.partition",
                      f"empty fused segment [{int(lo)}, {int(hi)})")
        flat.extend(range(int(lo), int(hi)))
    if flat != list(range(T)):
        sink.fail(
            "kc.segments.partition",
            f"fused segments {segs.tolist()} do not partition [0, {T}) "
            "in order",
        )
        return
    if plan.config.sched == "dagpart":
        # the fused executor walks merged steps: a segment boundary inside a
        # merge group would shear the launch against the step table
        so = _valid_step_off(plan)
        bounds = set() if so is None else {int(v) for v in so}
        for lo, hi in segs:
            for edge in (int(lo), int(hi)):
                if edge not in bounds:
                    sink.fail(
                        "kc.segments.partition",
                        f"fused segment edge {edge} splits a merged "
                        "superstep (segment boundaries must sit on "
                        f"step_off boundaries {sorted(bounds)})",
                        level=edge if edge < T else None,
                    )
    if (plan.config.comm == "zerocopy" and plan.n_devices > 1
            and plan.n_boundary_rows > 0):
        wid = _widths(plan)
        starts = {int(lo) for lo, _ in segs}
        for t in range(T):
            if wid[t, 2] > 0 and t not in starts:
                sink.fail(
                    "kc.segments.partition",
                    f"level {t} has a non-empty exchange bucket but sits "
                    "mid-segment — a fused launch exchanges only at its "
                    "start, so this exchange never runs", level=t,
                )


# ---------------------------------------------------------------------------
# streaming, scratch and the pull table: the port's megakernel contracts
# ---------------------------------------------------------------------------


def _slice_entries(plan: "Plan", col: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat positions of schedule ``col`` (0 solve, 1 update) that the
    level slices hold (every device's flat shares the offsets), and each
    one's level, clamped to the flat (out-of-range slices are
    ``kc.stream.slices`` findings)."""
    flat = plan.solve_rows.shape[1] if col == 0 else plan.upd_tiles.shape[1]
    off = np.asarray(plan.lvl_off[:, col], np.int64)
    lo = np.clip(off, 0, flat)
    hi = np.maximum(lo, np.clip(off + _widths(plan)[:, col], 0, flat))
    n = hi - lo
    lvl = np.repeat(np.arange(n.shape[0]), n)
    first = np.cumsum(n) - n
    return np.repeat(lo, n) + np.arange(lvl.shape[0]) - np.repeat(first, n), lvl


def _launch_work(plan: "Plan", d: int) -> tuple[np.ndarray, int]:
    """Device ``d``'s work in its one launch, counted from the plan's slices
    (not from a layout): per block row, the tiles pulled into it plus one
    for its diagonal tile where the row is solved; and the number of such
    entries. Pad solve slots and updates into the pad row are left out,
    as the kernel leaves them out."""
    nb = plan.bs.nb
    spos, _ = _slice_entries(plan, 0)
    rows = plan.solve_rows[d][spos].astype(np.int64)
    rows = rows[(rows >= 0) & (rows < nb)]
    upos, _ = _slice_entries(plan, 1)
    slots = plan.upd_tiles[d][upos].astype(np.int64)
    slots = slots[(slots >= 0) & (slots < plan.tile_row.shape[1])]
    dest = plan.tile_row[d][slots].astype(np.int64)
    dest = dest[(dest >= 0) & (dest < nb)]
    items = np.bincount(dest, minlength=nb + 1) + np.bincount(rows, minlength=nb + 1)
    return items, int(items.sum())


def _check_streaming(plan: "Plan", sink: RuleSink) -> None:
    from repro_torch.core.solver import (
        fused_layouts, fused_streaming, fused_vmem_bytes, stream_dma_bytes_per_solve,
        stream_widths,
    )
    from repro_torch.kernels import superstep

    for rule in ("kc.stream.ladder", "kc.stream.slices", "kc.stream.bytes",
                 "kc.scratch.shape"):
        sink.check(rule)
    B = plan.bs.B
    T = plan.n_levels
    wid = _widths(plan)
    # ladders are per *superstep*: a merged step's slices are one
    # contiguous run (identical to the per-level widths for unmerged plans)
    so = _valid_step_off(plan)
    if so is None:  # pragma: no cover - gated by kc.steps.partition upstream
        return
    cs = np.zeros((T + 1, 3), dtype=np.int64)
    if T:
        np.cumsum(wid, axis=0, out=cs[1:])
    swid = cs[so[1:]] - cs[so[:-1]]
    n_steps = swid.shape[0]
    sw, uw = stream_widths(plan)
    for name, lad, col in (("solve", sw, 0), ("update", uw, 1)):
        actual = ({int(w) for w in swid[:, col]} if n_steps else {0})
        if set(lad) != actual:
            sink.fail(
                "kc.stream.ladder",
                f"{name} width ladder {sorted(lad)} != distinct superstep "
                f"widths {sorted(actual)}",
            )

    # the level slices of the flats: disjoint, covering the footprint (the
    # flats' lengths are the extents of streamed_stores, not built here)
    extents = (plan.solve_rows.shape[1], plan.upd_tiles.shape[1])
    for name, col, extent in (("solve", 0, extents[0]),
                              ("update", 1, extents[1])):
        cover = np.zeros(extent, dtype=np.int64)
        for t in range(T):
            lo = int(plan.lvl_off[t, col])
            hi = lo + int(wid[t, col])
            if lo < 0 or hi > extent:
                sink.fail(
                    "kc.stream.slices",
                    f"level {t} {name} slice [{lo}, {hi}) leaves the flat "
                    f"extent [0, {extent})", level=t,
                )
                continue
            cover[lo:hi] += 1
        over = np.nonzero(cover > 1)[0]
        if over.size:
            sink.fail(
                "kc.stream.slices",
                f"{over.size} {name} flat slots are claimed by more than "
                f"one level slice (first at flat index {int(over[0])}) — "
                "the megakernel would run one level's entry in another "
                "level too",
            )
        used = int(wid[:, col].sum()) if T else 0
        gap = np.nonzero(cover[:used] == 0)[0]
        if gap.size:
            sink.fail(
                "kc.stream.slices",
                f"{gap.size} {name} flat slots inside the schedule "
                f"footprint are covered by no level slice (first at flat "
                f"index {int(gap[0])})",
            )

    # the streamed store's layout and the pull table, one launch per device
    try:
        layouts = fused_layouts(plan)
    except ValueError as e:
        # the pull order refuses tables that break happens-before: when the
        # hb.* walks have already said so, do not cascade
        if not any(f.severity == ERROR and f.rule.startswith("hb.") for f in sink.findings):
            sink.fail("kc.stream.slices",
                      f"the schedule cannot be laid out for the megakernel: {e}")
        return
    for d, layout in enumerate(layouts):
        _check_layout(plan, d, layout, sink)

    work = [_launch_work(plan, d) for d in range(plan.n_devices)]
    copied = max(c for _, c in work) if work else 0
    for R in (1, 8):
        want = R * copied * 4 * superstep.stream_tile_floats(B) if T else 0
        got = stream_dma_bytes_per_solve(plan, R, layouts=layouts)
        if got != want:
            sink.fail(
                "kc.stream.bytes",
                f"stream_dma_bytes_per_solve(R={R}) reports {got} bytes but the "
                f"plan's slices copy {copied} entries of "
                f"{superstep.stream_tile_floats(B)} floats per column ({want} bytes)",
            )

    _, _, rows = superstep.streamed_shape(B, 1)
    chunks = superstep.stream_chunks(B, rows)
    ends = [e for chunk in chunks for e in chunk]
    stage = superstep.stage_floats(B, 1, rows)
    if (ends[0] != 0 or ends[-1] != superstep.stream_tile_floats(B)
            or any(a != b for a, b in zip(ends[1:-1:2], ends[2::2]))
            or any(e % 4 for e in ends) or any(t - f > stage for f, t in chunks)):
        sink.fail(
            "kc.stream.bytes",
            f"the bulk copies of one B={B} entry ({len(chunks)} chunks of at most {rows} "
            f"rows, float ranges {chunks[:3]}...) do not cover its "
            f"{superstep.stream_tile_floats(B)} floats once in 16-byte-aligned pieces that "
            f"fit a stage of {stage} floats",
        )

    widest = max((int(items.max()) for items, _ in work), default=0)
    need = {False: superstep.shared_bytes(B),
            True: superstep.streamed_shared_bytes(B, widest)}
    for streamed, want in need.items():
        got = fused_vmem_bytes(plan, streamed=streamed, layouts=layouts)
        if got != want:
            sink.fail(
                "kc.scratch.shape",
                f"{'streamed' if streamed else 'resident'} launch requests {got} "
                f"bytes of shared memory, the kernel's rule for B={B} (widest work "
                f"item {widest} tiles) gives {want}",
            )
    warps, cap, rows = superstep.streamed_shape(B, widest)
    if rows < B and (warps != superstep.chunk_warps(B) or cap != 1 or rows % 4
                     or rows > 32 * warps):
        sink.fail(
            "kc.scratch.shape",
            f"the streamed launch of B={B} in row chunks takes {warps} warps, {cap} "
            f"entries and {rows} rows a stage; the kernel's rule is one CTA of "
            f"{superstep.chunk_warps(B)} warps an item, one entry's chunks of a multiple "
            f"of four rows, at most one row a thread",
        )
    # the launch this plan makes, if it makes one, must fit a CTA
    if plan.config.kernel_backend in ("fused", "fused_streamed"):
        streamed = fused_streaming(plan)
        form = "streamed" if streamed else "resident"
        if need[streamed] > superstep.SHARED_LIMIT:
            sink.fail(
                "kc.scratch.shape",
                f"the {form} launch needs {need[streamed]} bytes of shared memory per "
                f"CTA, over the card's {superstep.SHARED_LIMIT}",
            )
        if B + 1 > superstep.STAGE_FLOATS:
            sink.fail(
                "kc.scratch.shape",
                f"the {form} launch of B={B} tiles is over the card's megakernel "
                f"limit: one padded tile row of {B + 1} floats in a resident stage of "
                f"{superstep.STAGE_FLOATS} (both forms take B < {superstep.STAGE_FLOATS})",
            )
    check_pull_wait(plan, [layout.table for layout in layouts], sink)


def _check_layout(plan: "Plan", d: int, layout, sink: RuleSink) -> None:
    """``kc.stream.slices`` on device ``d``'s streamed layout, against the
    work items re-derived from the plan's slices: target ``k < S`` is solve
    slot ``k``, target ``S + q`` the ``q``-th row (ascending) that receives
    updates in the launch but is not solved in it."""
    nb = plan.bs.nb
    S = layout.table.n_solve_slots
    ptr = np.asarray(layout.table.pull_ptr, np.int64)
    source = np.asarray(layout.source, np.int64)
    diag_entry = np.asarray(layout.diag_entry, np.int64)
    tile_entry = np.asarray(layout.tile_entry, np.int64)
    n_targets = ptr.shape[0] - 1
    n_entries = int(ptr[-1]) + S
    first = ptr[:-1] + np.minimum(np.arange(n_targets), S)
    last = ptr[1:] + np.minimum(np.arange(1, n_targets + 1), S)
    problems = []
    # every entry is named once, as a slot's diagonal or an update's tile
    named = np.concatenate([diag_entry, tile_entry[tile_entry >= 0]])
    counts = np.bincount(named, minlength=n_entries)
    if np.any(counts[:n_entries] != 1) or counts.shape[0] > n_entries:
        problems.append(f"{int(np.sum(counts > 1))} entries are claimed by more than one "
                        f"work item and {int(np.sum(counts[:n_entries] == 0))} by none")
    # tile_entry covers exactly the launch's updates into real rows
    sr = plan.solve_rows[d].astype(np.int64)
    ut = plan.upd_tiles[d].astype(np.int64)
    trow = plan.tile_row[d].astype(np.int64)
    upos, _ = _slice_entries(plan, 1)
    ucl = np.clip(ut[upos], 0, trow.shape[0] - 1)
    want_pos = np.unique(upos[trow[ucl] != nb])
    pos = np.nonzero(tile_entry >= 0)[0]
    if not np.array_equal(want_pos, pos):
        problems.append(f"tile_entry covers {pos.size} update positions, the launch "
                        f"applies {want_pos.size}")
    # each slot's diagonal entry ends its run and holds its row's diagonal
    if S and (diag_entry.shape[0] != S or np.any(diag_entry != last[:S] - 1)
              or np.any(source[np.clip(diag_entry, 0, source.shape[0] - 1)]
                        != np.where(sr[:S] < 0, nb, sr[:S]))):
        problems.append("a solve slot's diagonal entry is not the last of its run, or "
                        "holds another tile")
    # each update's entry holds its tile, inside its target's run
    if pos.size and pos[-1] < ut.shape[0]:
        spos, _ = _slice_entries(plan, 0)
        live = sr[spos] >= 0
        slot_of = np.full(nb + 1, -1, np.int64)
        slot_of[sr[spos[live]]] = spos[live]
        dest = trow[np.clip(ut[pos], 0, trow.shape[0] - 1)]
        orphans = np.unique(dest[slot_of[dest] < 0])
        target = np.where(slot_of[dest] >= 0, slot_of[dest],
                          S + np.searchsorted(orphans, dest))
        e = tile_entry[pos]
        t = np.clip(target, 0, n_targets - 1)
        wrong = int(np.sum((target >= n_targets) | (e < first[t])
                           | (e >= last[t] - (t < S))))
        wrong_tile = int(np.sum(source[np.clip(e, 0, source.shape[0] - 1)]
                                != nb + 1 + ut[pos]))
        if wrong:
            problems.append(f"{wrong} update entries lie outside their work item's run")
        if wrong_tile:
            problems.append(f"{wrong_tile} update entries hold another tile than the "
                            "update reads")
    for p in problems:
        sink.fail("kc.stream.slices", f"streamed layout: {p}", device=d)


def check_pull_wait(plan: "Plan", tables: list, sink: RuleSink) -> None:
    """``kc.pull.wait`` on one :class:`~repro_torch.kernels.superstep.SuperstepTable`
    per device (the launch over the whole schedule): ``pull_wait`` is 1
    exactly where ``pull_col`` is a row the launch solves, which is
    re-derived here from the plan's solve slices."""
    sink.check("kc.pull.wait")
    nb = plan.bs.nb
    for d, table in enumerate(tables):
        spos, _ = _slice_entries(plan, 0)
        rows = plan.solve_rows[d][spos].astype(np.int64)
        solved = np.zeros(nb + 1, bool)
        solved[rows[(rows >= 0) & (rows < nb)]] = True
        n_pull = int(np.asarray(table.pull_ptr)[-1])
        col = np.asarray(table.pull_col, np.int64)[:n_pull]
        wait = np.asarray(table.pull_wait, np.int64)[:n_pull]
        want = solved[np.clip(col, 0, nb)].astype(np.int64)
        bad = np.nonzero(wait != want)[0]
        if bad.size:
            spin = int(np.sum((wait == 1) & (want == 0)))
            what = []
            if spin:
                what.append(f"{spin} would wait on a row the launch never solves")
            if bad.size - spin:
                what.append(f"{bad.size - spin} would read a row before it is solved")
            sink.fail(
                "kc.pull.wait",
                f"{bad.size} pulled tiles carry the wrong wait bit ({', '.join(what)})",
                device=d, rows=col[bad],
            )
