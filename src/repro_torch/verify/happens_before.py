"""Happens-before race detection over compacted schedules.

Reconstructs the dependency DAG from the block structure (``off_rows`` /
``off_cols`` — the ground-truth sparsity, *not* the builder's own
``block_level`` analysis) and replays every per-device compacted schedule
positionally, proving the executors' bulk-synchronous timeline respects every
dependency. The semantics are **positional**, not level-identity: a tile
update scheduled in superstep ``t`` is legal whenever its source row's solve
lands in an earlier superstep *or earlier in the same superstep* (solves
precede updates inside one fused/switch superstep body) — exactly the
legality condition the DAG-partition scheduler (``sched="dagpart"``) must
satisfy when it merges levels, which is what makes this module the legality
oracle gating that scheduler: merged plans replay through the *same* walks
(micro-level in-superstep order is exactly the kernel's sequential rowsweep),
plus one merged-step-specific rule for unified comm below.

Executor timeline being modelled (one superstep ``t``, all executors):

    exchange(t)  →  solve slice t  →  update slice t  →  exchange(t+1) → ...

Rule catalogue (``hb.*``; all errors unless noted):

* ``hb.dag.lower-triangular`` — every off-diagonal tile has ``col < row``
  (the quotient graph is acyclic by construction; a violation poisons every
  downstream ordering claim).
* ``hb.solve.range`` / ``hb.solve.owner`` / ``hb.solve.once`` — every real
  block row is solved exactly once, on exactly the device that owns it, and
  every scheduled entry is a valid row inside a level slice.
* ``hb.upd.range`` / ``hb.upd.owner`` / ``hb.upd.once`` / ``hb.upd.pattern``
  — per-device tile stores are a bijection with the pattern's tiles (each
  tile resident exactly once, on its source column's owner), and every real
  store slot is scheduled exactly once.
* ``hb.upd.src-before`` — a tile update's source row is solved in an earlier
  superstep, or earlier in in-superstep order (solves-before-updates).
* ``hb.upd.dest-after`` — a tile update lands strictly before its
  destination row's solve (same-superstep is a race: the superstep body
  solves *before* updating, so the contribution would be lost). For merged
  (``dagpart``) plans "superstep" here means micro-level: the in-kernel
  rowsweep runs each merged micro-level's solves before its updates.
* ``hb.upd.dest-step`` — merged plans under ``comm="unified"`` only: a
  *cross-device* tile update must land in a strictly earlier merged
  superstep than its destination row's solve. The unified executor folds
  the cross-device delta into ``acc`` only at superstep boundaries, so a
  remote contribution computed in the same merged step as the destination
  solve — even at an earlier micro-level — never reaches the owner.
* ``hb.exchange.gate`` / ``hb.exchange.missing`` / ``hb.exchange.once`` /
  ``hb.exchange.position`` — every cross-device dependency is covered by an
  exchange that executes after the last remote update into the row and no
  later than the row's solve superstep, exactly once (a second psum of an
  already-combined row multiplies the pre-exchange contributions by the
  device count — silent wrong answers).
* ``hb.exchange.spurious`` (warning) — a row is exchanged though no remote
  device contributes to it (correct, but pure pad traffic).
* ``hb.exchange.degenerate`` (warning) — the plan schedules collective
  traffic (``comm_bytes_per_solve > 0`` or per-level fused segmentation)
  over an *empty* dependency cut: every update is device-local, so every
  psum carries zeros and every extra launch split is pure overhead.
* ``hb.syncfree.caps`` — ``frontier_caps`` are true upper bounds on the
  runtime frontier. The reference's syncfree executor marks *all* ready rows
  solved even when the dispatched branch width is smaller, so there an
  undershooting cap silently drops solves. The port's frontier form
  (``core.solver._SyncfreeSchedule.width``) raises instead when a frontier
  outgrows its width ladder, which the caps bound: on the port a cap that
  undershoots fails the solve rather than dropping rows. Either way the plan
  is wrong, so the rule and its severity are the reference's.

The rule ids, severities and walks are the reference package's
(``repro.verify.happens_before``); the port's plans carry the same arrays,
byte for byte, so both verifiers see the same schedules. Multi-device plans
(``hb.exchange.*``, ``hb.upd.dest-step``) are checked too: the port builds
them though it does not execute them yet, so this module is the legality
check the multi-device executors will run against.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.verify.report import WARNING, RuleSink

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from repro_torch.core.solver import Plan


def _recompute_levels(nb: int, off_rows: np.ndarray, off_cols: np.ndarray
                      ) -> np.ndarray:
    """Block levels from the tile pattern alone — an independent
    reimplementation of the wavefront analysis (used only for the syncfree
    frontier-cap bound, where the runtime discovers exactly these levels)."""
    lvl = np.zeros(nb, dtype=np.int64)
    order = np.argsort(off_rows, kind="stable")
    sr, sc = off_rows[order], off_cols[order]
    ptr = np.searchsorted(sr, np.arange(nb + 1))
    for r in range(nb):
        lo, hi = ptr[r], ptr[r + 1]
        if hi > lo:
            lvl[r] = lvl[sc[lo:hi]].max() + 1
    return lvl


def _level_slices(plan: "Plan", col: int, flat_len: int) -> list:
    """``[(t, lo, hi), ...]`` clamped slices of schedule column ``col``
    (0=solve, 1=update, 2=exchange). Malformed offsets are clamped here and
    *flagged* by the kernel-contract lint (``kc.offsets.cumsum``); the
    happens-before walk then reports what the clamped schedule actually
    executes (dropped rows surface as ``hb.solve.once`` etc.)."""
    bid = np.clip(plan.lvl_bucket, 0, len(plan.buckets) - 1)
    wid = np.asarray(plan.buckets, dtype=np.int64)[bid]
    out = []
    for t in range(plan.n_levels):
        lo = int(plan.lvl_off[t, col])
        hi = lo + int(wid[t, col])
        out.append((t, max(0, min(lo, flat_len)), max(0, min(hi, flat_len))))
    return out


def _step_of_levels(plan: "Plan") -> np.ndarray | None:
    """Micro-level -> merged-superstep map from ``plan.step_off``; identity
    for unmerged plans. ``None`` when the table is malformed — the
    kernel-contract lint (``kc.steps.partition``) owns that finding, and the
    ordering walk must not cascade noise off unusable data."""
    T = plan.n_levels
    if plan.step_off is None:
        return np.arange(T, dtype=np.int64)
    so = np.asarray(plan.step_off).ravel()
    if (so.size < 1 or int(so[0]) != 0 or int(so[-1]) != T
            or (so.size > 1 and np.any(np.diff(so) <= 0))):
        return None
    return np.repeat(np.arange(so.size - 1, dtype=np.int64), np.diff(so))


def check_happens_before(plan: "Plan", sink: RuleSink) -> None:
    bs, part, cfg = plan.bs, plan.part, plan.config
    nb, D = bs.nb, plan.n_devices
    owner = np.asarray(part.owner)
    off_rows = np.asarray(bs.off_rows, dtype=np.int64)
    off_cols = np.asarray(bs.off_cols, dtype=np.int64)

    # --- the dependency DAG itself -------------------------------------
    sink.check("hb.dag.lower-triangular")
    bad = np.nonzero(off_cols >= off_rows)[0]
    if bad.size:
        sink.fail(
            "hb.dag.lower-triangular",
            f"{bad.size} off-diagonal tiles are not strictly lower-triangular",
            tiles=zip(off_rows[bad], off_cols[bad]),
        )
        return  # the DAG is not a DAG; ordering claims below are meaningless

    sink.check("hb.solve.owner")
    if nb and (owner.min() < 0 or owner.max() >= D):
        rows = np.nonzero((owner < 0) | (owner >= D))[0]
        sink.fail("hb.solve.owner",
                  f"{rows.size} rows have an owner outside [0, {D})",
                  rows=rows)
        return

    remote = owner[off_cols] != owner[off_rows]  # tile computed off-owner
    remote_dest = set(np.unique(off_rows[remote]).tolist())
    tile_of = {(int(r), int(c)): i
               for i, (r, c) in enumerate(zip(off_rows, off_cols))}

    if cfg.sched in ("levelset", "dagpart"):
        solve_level = _check_levelset_solves(plan, sink, owner)
        upd_level = _check_levelset_updates(plan, sink, owner, tile_of)
        _check_ordering(plan, sink, solve_level, upd_level, tile_of)
        _check_levelset_exchange(plan, sink, remote_dest, solve_level,
                                 upd_level, tile_of, off_rows, off_cols,
                                 remote)
    else:
        lvl = _recompute_levels(nb, off_rows, off_cols)
        _check_syncfree(plan, sink, owner, tile_of, remote_dest, lvl)

    # --- degenerate communication over an empty cut --------------------
    sink.check("hb.exchange.degenerate")
    if D > 1 and not remote_dest:
        comm = plan.comm_bytes_per_solve
        if comm > 0:
            sink.fail(
                "hb.exchange.degenerate",
                f"plan schedules {comm} collective bytes/solve over an empty "
                "dependency cut (every update is device-local)",
                severity=WARNING,
            )
        if cfg.sched in ("levelset", "dagpart") and all(
                0 <= int(b) < len(plan.buckets) for b in plan.lvl_bucket):
            from repro_torch.core.solver import fused_segments

            n_seg = len(fused_segments(plan))
            if n_seg > 1:
                sink.fail(
                    "hb.exchange.degenerate",
                    f"fused execution splits into {n_seg} launches over an "
                    "empty cut (one launch suffices: no psum is needed)",
                    severity=WARNING,
                )


# -----------------------------------------------------------------------
# levelset schedule walks
# -----------------------------------------------------------------------


def _check_levelset_solves(plan: "Plan", sink: RuleSink, owner: np.ndarray
                           ) -> dict:
    """Walk ``solve_rows`` slices; returns ``{row: superstep}``."""
    nb, D = plan.bs.nb, plan.n_devices
    S = plan.solve_rows.shape[1]
    slices = _level_slices(plan, 0, S)
    for rule in ("hb.solve.range", "hb.solve.owner", "hb.solve.once"):
        sink.check(rule)

    solve_level: dict = {}
    dup: dict = {}
    covered = np.zeros(S, dtype=bool)
    for t, lo, hi in slices:
        covered[lo:hi] = True
        for d in range(D):
            for r in plan.solve_rows[d, lo:hi]:
                r = int(r)
                if r == -1:
                    continue  # pad
                if not 0 <= r < nb:
                    sink.fail("hb.solve.range",
                              f"solve entry {r} outside [0, {nb})",
                              level=t, device=d)
                    continue
                if int(owner[r]) != d:
                    sink.fail(
                        "hb.solve.owner",
                        f"row {r} scheduled on device {d} but owned by "
                        f"device {int(owner[r])}", level=t, device=d, rows=[r],
                    )
                if r in solve_level:
                    dup.setdefault(r, [solve_level[r]]).append(t)
                else:
                    solve_level[r] = t
    for d in range(D):
        stray = [int(r) for r in plan.solve_rows[d][~covered] if int(r) != -1]
        if stray:
            sink.fail(
                "hb.solve.range",
                f"{len(stray)} solve entries sit outside every level slice "
                "(never executed)", device=d, rows=stray,
            )
    if dup:
        for r, lvls in dup.items():
            sink.fail(
                "hb.solve.once",
                f"row {r} solved {len(lvls)} times (supersteps {lvls})",
                rows=[r],
            )
    missing = [r for r in range(nb) if r not in solve_level]
    if missing:
        sink.fail(
            "hb.solve.once",
            f"{len(missing)} rows are never solved by any device's schedule",
            rows=missing,
        )
    return solve_level


def _resident_slots(plan: "Plan", d: int) -> list:
    """Real tile slots of device ``d``'s store (pad slots carry dest ``nb``)."""
    nb = plan.bs.nb
    ML = plan.tiles.shape[1] - 1
    return [s for s in range(ML) if int(plan.tile_row[d, s]) != nb]


def _check_tile_stores(plan: "Plan", sink: RuleSink, owner: np.ndarray,
                       tile_of: dict) -> None:
    """Store/pattern bijection: every pattern tile resident exactly once, on
    its source column's owner; no fabricated tiles."""
    for rule in ("hb.upd.pattern", "hb.upd.owner"):
        sink.check(rule)
    seen: dict = {}
    for d in range(plan.n_devices):
        for s in _resident_slots(plan, d):
            r, c = int(plan.tile_row[d, s]), int(plan.tile_col[d, s])
            if (r, c) not in tile_of:
                sink.fail("hb.upd.pattern",
                          f"device {d} store slot {s} holds tile ({r},{c}) "
                          "absent from the matrix pattern",
                          device=d, tiles=[(r, c)])
                continue
            if int(owner[c]) != d:
                sink.fail(
                    "hb.upd.owner",
                    f"tile ({r},{c}) resident on device {d} but its source "
                    f"column is owned by device {int(owner[c])}",
                    device=d, tiles=[(r, c)],
                )
            if (r, c) in seen:
                sink.fail("hb.upd.pattern",
                          f"tile ({r},{c}) resident on devices "
                          f"{seen[(r, c)]} and {d}", tiles=[(r, c)])
            seen[(r, c)] = d
    absent = [rc for rc in tile_of if rc not in seen]
    if absent:
        sink.fail(
            "hb.upd.pattern",
            f"{len(absent)} pattern tiles are resident on no device "
            "(their updates can never execute)", tiles=absent,
        )


def _check_levelset_updates(plan: "Plan", sink: RuleSink, owner: np.ndarray,
                            tile_of: dict) -> dict:
    """Walk ``upd_tiles`` slices; returns ``{(dest, src): superstep}``."""
    nb, D = plan.bs.nb, plan.n_devices
    ML = plan.tiles.shape[1] - 1
    U = plan.upd_tiles.shape[1]
    slices = _level_slices(plan, 1, U)
    for rule in ("hb.upd.range", "hb.upd.once"):
        sink.check(rule)
    _check_tile_stores(plan, sink, owner, tile_of)

    upd_level: dict = {}
    scheduled: dict = {}
    for t, lo, hi in slices:
        for d in range(D):
            for s in plan.upd_tiles[d, lo:hi]:
                s = int(s)
                if s == ML:
                    continue  # pad slot (zero tile, dest nb)
                if not 0 <= s < ML:
                    sink.fail("hb.upd.range",
                              f"update entry {s} outside [0, {ML}]",
                              level=t, device=d)
                    continue
                r, c = int(plan.tile_row[d, s]), int(plan.tile_col[d, s])
                if r == nb:
                    continue  # unfilled store slot: zero tile, inert
                if (d, s) in scheduled:
                    sink.fail(
                        "hb.upd.once",
                        f"tile ({r},{c}) updated twice (supersteps "
                        f"{scheduled[(d, s)]} and {t}) — double-counted "
                        "contribution", level=t, device=d, tiles=[(r, c)],
                    )
                else:
                    scheduled[(d, s)] = t
                    upd_level[(r, c)] = t
    for d in range(D):
        missing = [s for s in _resident_slots(plan, d)
                   if (d, s) not in scheduled]
        if missing:
            tiles = [(int(plan.tile_row[d, s]), int(plan.tile_col[d, s]))
                     for s in missing]
            sink.fail(
                "hb.upd.once",
                f"{len(missing)} resident tiles are never scheduled "
                "(their contributions are dropped)", device=d, tiles=tiles,
            )
    return upd_level


def _check_ordering(plan: "Plan", sink: RuleSink, solve_level: dict,
                    upd_level: dict, tile_of: dict) -> None:
    for rule in ("hb.upd.src-before", "hb.upd.dest-after"):
        sink.check(rule)
    for (r, c), t in upd_level.items():
        tc = solve_level.get(c)
        # missing solves were already flagged by hb.solve.once — don't cascade
        if tc is not None and tc > t:
            sink.fail(
                "hb.upd.src-before",
                f"tile ({r},{c}) updates in superstep {t} but its source row "
                f"{c} is only solved in superstep {tc}", level=t,
                tiles=[(r, c)],
            )
        tr = solve_level.get(r)
        if tr is not None and t >= tr:
            sink.fail(
                "hb.upd.dest-after",
                f"tile ({r},{c}) updates in superstep {t} but its "
                f"destination row {r} solves in superstep {tr} "
                "(solves precede updates inside a superstep, so the "
                "contribution is lost)", level=t, tiles=[(r, c)],
            )

    # merged steps under unified comm: the dense delta psum folds into acc
    # only at superstep *boundaries*, so a cross-device update must complete
    # in a strictly earlier merged step than its destination's solve — the
    # micro-level ordering above is not enough once levels share a step
    cfg = plan.config
    if not (cfg.sched == "dagpart" and cfg.comm == "unified"
            and plan.n_devices > 1):
        return
    step_of = _step_of_levels(plan)
    if step_of is None:
        return  # malformed step table: kc.steps.partition owns this
    sink.check("hb.upd.dest-step")
    owner = np.asarray(plan.part.owner)
    for (r, c), t in upd_level.items():
        if int(owner[c]) == int(owner[r]):
            continue  # device-local: the in-step sequential sweep covers it
        tr = solve_level.get(r)
        if tr is None or not (0 <= t < len(step_of) and 0 <= tr < len(step_of)):
            continue  # missing/ranged solves already flagged — don't cascade
        if step_of[t] >= step_of[tr]:
            sink.fail(
                "hb.upd.dest-step",
                f"remote tile ({r},{c}) updates in merged superstep "
                f"{int(step_of[t])} but its destination row {r} solves in "
                f"superstep {int(step_of[tr])} on device {int(owner[r])} — "
                "unified comm folds the cross-device delta only at superstep "
                "boundaries, so the contribution never arrives",
                level=t, tiles=[(r, c)],
            )


def _check_levelset_exchange(plan: "Plan", sink: RuleSink, remote_dest: set,
                             solve_level: dict, upd_level: dict,
                             tile_of: dict, off_rows, off_cols, remote
                             ) -> None:
    cfg = plan.config
    nb, D = plan.bs.nb, plan.n_devices
    if cfg.comm != "zerocopy" or D == 1:
        # unified's dense per-superstep psum covers every remote dependency
        # with update-superstep < solve-superstep, which hb.upd.dest-after
        # already proves; single-device plans have no exchanges at all
        return
    for rule in ("hb.exchange.gate", "hb.exchange.range", "hb.exchange.once",
                 "hb.exchange.missing", "hb.exchange.position",
                 "hb.exchange.spurious"):
        sink.check(rule)
    # the executors gate the packed psum on the partition reporting a
    # non-empty cut: if the gate is off, the ex schedule is dead data
    gate_on = plan.n_boundary_rows > 0
    if not gate_on:
        if remote_dest:
            sink.fail(
                "hb.exchange.gate",
                f"{len(remote_dest)} rows receive remote contributions but "
                "the partition reports an empty cut, so executors skip the "
                "exchange entirely", rows=sorted(remote_dest),
            )
        return

    E = plan.ex_rows.shape[0]
    ex_level: dict = {}
    for t, lo, hi in _level_slices(plan, 2, E):
        for r in plan.ex_rows[lo:hi]:
            r = int(r)
            if r == nb:
                continue  # pad (psum of the inert pad slot)
            if not 0 <= r < nb:
                sink.fail("hb.exchange.range",
                          f"exchange entry {r} outside [0, {nb}]", level=t)
                continue
            if r in ex_level:
                sink.fail(
                    "hb.exchange.once",
                    f"row {r} exchanged twice (supersteps {ex_level[r]} and "
                    f"{t}) — the second psum multiplies already-combined "
                    f"contributions by the device count", level=t, rows=[r],
                )
            else:
                ex_level[r] = t

    # per remote-dependent row: covered, exactly once, correctly positioned
    remote_upds: dict = {}
    for i in np.nonzero(remote)[0]:
        remote_upds.setdefault(int(off_rows[i]), []).append(int(off_cols[i]))
    for r in sorted(remote_dest):
        te = ex_level.get(r)
        if te is None:
            sink.fail(
                "hb.exchange.missing",
                f"row {r} receives remote contributions but is never "
                "exchanged — its solve reads only the local partial sum",
                level=solve_level.get(r), rows=[r],
            )
            continue
        tr = solve_level.get(r)
        if tr is not None and te > tr:
            sink.fail(
                "hb.exchange.position",
                f"row {r} is exchanged in superstep {te}, after its solve in "
                f"superstep {tr}", level=te, rows=[r],
            )
        for c in remote_upds[r]:
            tu = upd_level.get((r, c))
            # exchanges run at the *start* of a superstep, updates at its
            # end: a remote update needs a strictly later exchange to land
            if tu is not None and tu >= te:
                sink.fail(
                    "hb.exchange.position",
                    f"remote update ({r},{c}) lands in superstep {tu} but "
                    f"row {r}'s exchange already ran at the start of "
                    f"superstep {te} — the contribution is stranded on "
                    f"device {int(plan.part.owner[c])}", level=te,
                    rows=[r], tiles=[(r, c)],
                )
    spurious = sorted(set(ex_level) - remote_dest)
    if spurious:
        sink.fail(
            "hb.exchange.spurious",
            f"{len(spurious)} exchanged rows have no remote contributions "
            "(the psum only echoes the local value)", severity=WARNING,
            rows=spurious,
        )


# -----------------------------------------------------------------------
# syncfree plans
# -----------------------------------------------------------------------


def _check_syncfree(plan: "Plan", sink: RuleSink, owner: np.ndarray,
                    tile_of: dict, remote_dest: set, lvl: np.ndarray) -> None:
    nb, D = plan.bs.nb, plan.n_devices
    cfg = plan.config
    for rule in ("hb.solve.range", "hb.solve.owner", "hb.solve.once"):
        sink.check(rule)
    seen: dict = {}
    for d in range(D):
        for r in plan.local_rows[d]:
            r = int(r)
            if r == nb:
                continue  # pad
            if not 0 <= r < nb:
                sink.fail("hb.solve.range",
                          f"local row {r} outside [0, {nb}]", device=d)
                continue
            if int(owner[r]) != d:
                sink.fail("hb.solve.owner",
                          f"row {r} in device {d}'s local set but owned by "
                          f"device {int(owner[r])}", device=d, rows=[r])
            if r in seen:
                sink.fail("hb.solve.once",
                          f"row {r} in local sets of devices {seen[r]} "
                          f"and {d}", device=d, rows=[r])
            seen[r] = d
    missing = [r for r in range(nb) if r not in seen]
    if missing:
        sink.fail("hb.solve.once",
                  f"{len(missing)} rows are in no device's local set "
                  "(the solve never terminates)", rows=missing)

    _check_tile_stores(plan, sink, owner, tile_of)

    # packed boundary exchange (zerocopy): membership + multiplicity. The
    # runtime psums every sweep, so positioning is structural — only coverage
    # can break statically.
    if cfg.comm == "zerocopy" and D > 1:
        for rule in ("hb.exchange.gate", "hb.exchange.once",
                     "hb.exchange.missing", "hb.exchange.spurious"):
            sink.check(rule)
        gate_on = plan.n_boundary_rows > 0
        exb = [int(r) for r in plan.ex_boundary if int(r) != nb]
        if not gate_on:
            if remote_dest:
                sink.fail(
                    "hb.exchange.gate",
                    f"{len(remote_dest)} rows receive remote contributions "
                    "but the partition reports an empty cut, so the runtime "
                    "skips the packed exchange", rows=sorted(remote_dest),
                )
        else:
            counts: dict = {}
            for r in exb:
                counts[r] = counts.get(r, 0) + 1
            dups = sorted(r for r, k in counts.items() if k > 1)
            if dups:
                sink.fail(
                    "hb.exchange.once",
                    f"{len(dups)} rows appear multiple times in ex_boundary "
                    "— scatter-add double-counts their psum", rows=dups,
                )
            missing_ex = sorted(remote_dest - set(counts))
            if missing_ex:
                sink.fail(
                    "hb.exchange.missing",
                    f"{len(missing_ex)} remote-dependent rows missing from "
                    "ex_boundary", rows=missing_ex,
                )
            spurious = sorted(set(counts) - remote_dest)
            if spurious:
                sink.fail(
                    "hb.exchange.spurious",
                    f"{len(spurious)} ex_boundary rows have no remote "
                    "contributions", severity=WARNING, rows=spurious,
                )

    # frontier caps: the ladder's top branch must cover the widest frontier
    # any device can see in any sweep (= its widest block level)
    sink.check("hb.syncfree.caps")
    cap_s, cap_u = int(plan.frontier_caps[0]), int(plan.frontier_caps[1])
    T = int(lvl.max()) + 1 if nb else 0
    need_s = need_u = 0
    for d in range(D):
        mine = owner == d
        if nb:
            need_s = max(need_s, int(np.bincount(
                lvl[mine], minlength=max(T, 1)).max(initial=0)))
        slots = _resident_slots(plan, d)
        if slots:
            src_lvl = lvl[[int(plan.tile_col[d, s]) for s in slots]]
            need_u = max(need_u, int(np.bincount(
                src_lvl, minlength=max(T, 1)).max(initial=0)))
    if need_s > cap_s:
        sink.fail(
            "hb.syncfree.caps",
            f"frontier solve cap {cap_s} undershoots the widest per-device "
            f"level ({need_s} rows) — ready rows beyond the dispatched "
            "branch are marked solved but never computed",
        )
    if need_u > cap_u:
        sink.fail(
            "hb.syncfree.caps",
            f"frontier update cap {cap_u} undershoots the widest per-device "
            f"tile frontier ({need_u} tiles) — their contributions are "
            "silently dropped",
        )
