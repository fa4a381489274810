"""SpTRSV plans and their executors.

Plan construction is host numpy and byte-identical to the reference
package's: block rows are owned by a :class:`~repro_torch.core.partition.Partition`,
tiles live on the owner of their *column*, and every schedule is stored
*ragged* — one flat array per schedule (``solve_rows``, ``upd_tiles``,
``ex_rows``) plus per-level offsets (``lvl_off``), each level's slice padded
only up to a *bucket width* from a small ladder (``Plan.buckets``).

Execution (:class:`Solver`) runs on one device per process.
``sched="levelset"`` and ``"dagpart"`` plans run on one of two executors:

* the per-level switch executor (backends ``reference`` and ``cuda``): for
  each block level, gather the level's rows, solve their diagonal tiles
  (block TRSV/TRSM), then apply the tile updates they source (block
  GEMV/GEMM) with an ``index_add_`` into the accumulator. Level offsets and
  widths are host Python ints, so the loop never waits on the device;
* ``kernel_backend="fused"``: the whole solve is one launch of the resident
  superstep megakernel (:mod:`repro_torch.kernels.superstep`);
  ``"fused_streamed"``: one launch of its streamed form.

``sched="syncfree"`` plans run the synchronization-free executor: runtime
in-degree counters, no level tables. Backends ``reference`` and ``cuda``
run its dense scan (every sweep a masked TRSV over all rows and a masked
GEMV over all tiles); ``fused`` and ``fused_streamed`` run its
frontier-bucketed form (the ready rows and the tiles they source compacted
each sweep, solved and applied at a width from :func:`_frontier_ladder`).

``kernel_backend="fused"`` runs the resident megakernel up to a store size
and the streamed one above it (:func:`fused_streaming`, the limit measured
on the card, :data:`DEFAULT_STREAM_LIMIT`).

A multi-device plan (``n_devices = D > 1``) runs on ``D`` processes, one
per device, each a rank of a ``torch.distributed`` group
(:mod:`repro_torch.core.comm`) executing its device's tables: the
reference's ``shard_map`` executors, its ``psum`` an ``all_reduce``. Every
scheduler and backend runs there, under either comm mode:

* ``comm="zerocopy"`` (levelset, dagpart): right before a level whose
  exchange bucket is not empty, the ranks sum the accumulator's rows of
  that level's packed ``ex_rows`` slice (each boundary row once per solve).
  The switch executor does so inside its level loop; the fused backends
  launch the megakernel's split form once per :func:`fused_segments` range
  with the sum between launches, the accumulator in the split form's
  ``delta`` slot and a zero ``acc`` (``(b - 0) - delta`` is ``b - delta``
  bit for bit);
* ``comm="unified"`` (levelset, dagpart): before each superstep the ranks
  sum their ``delta`` carries into ``acc``; within it tile updates land in
  ``delta`` and solves read ``(b - acc) - delta`` (the reference's
  ``split_delta`` form). The switch executor runs the superstep's levels;
  the fused backends launch the split form once per superstep;
* ``sched="syncfree"``: updates into another rank's rows go to ``delta``
  (values) and ``dcnt`` (counts); after each sweep the ranks sum them,
  the boundary rows alone (zerocopy) or every row (unified), into their
  own, and count the rows left over the whole group.

The split launches' tables are built once per executor
(:func:`~repro_torch.kernels.superstep.segmented_layout`). With an empty
cut every update is local: no exchange, and a fused solve is one unsplit
launch. Every rank ends with the whole ``x`` (an ``all_reduce`` of each
rank's own rows).

Telemetry: :func:`build_plan` and :func:`refresh_plan` open the
``sptrsv.schedule`` / ``sptrsv.refresh`` spans (:mod:`repro_torch.obs.trace`);
the executors open ``torch.profiler.record_function`` ranges
(``sptrsv.level_solve``, ``sptrsv.tile_update``, ``sptrsv.superstep``,
``sptrsv.exchange``, ``sptrsv.gather``) only while a tracer is enabled or a
profiler session records.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import os
import warnings

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.blocking import (
    BlockStructure, build_blocks, pad_rhs, refresh_block_values, unpad_x,
)
from repro_torch.core.partition import (
    STRATEGIES, Partition, make_partition, merge_levels,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, superstep
from repro_torch.obs.trace import executor_scopes, get_tracer
from repro_torch.sparse.matrix import CSR, reverse_transpose

MAX_BUCKETS = 12  # cap on distinct (solve, update, exchange) width combos

COMM_MODES = ("zerocopy", "unified")
SCHED_MODES = ("levelset", "dagpart", "syncfree")
# scheds that execute the compacted levelset tables (dagpart is levelset plus
# a superstep coarsening on top of the same flats)
LEVELSET_SCHEDS = ("levelset", "dagpart")


def _check_choice(name: str, value, valid: tuple) -> None:
    if value not in valid:
        raise ValueError(
            f"invalid {name}: {value!r} (valid choices: {', '.join(valid)})"
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    block_size: int = 32
    comm: str = "zerocopy"  # "zerocopy" | "unified"
    sched: str = "levelset"  # "levelset" | "dagpart" | "syncfree"
    partition: str = "taskpool"  # "taskpool" | "contiguous" | "malleable"
    tasks_per_device: int = 8
    # None -> "cuda" on a CUDA device, "reference" on the CPU (kernels.ops)
    kernel_backend: str | None = None
    gemv_group: int = 0
    rhs_hint: int = 1  # expected RHS panel width R, feeds the partition cost model
    # dagpart merge heuristic knobs (ignored by the other scheds):
    # merge_width caps the busiest device's accumulated rows per merged
    # superstep; merge_cost is the narrow-level cost threshold (0 -> the
    # costmodel.merge_cost_threshold default)
    merge_width: int = 64
    merge_cost: float = 0.0
    # price malleable placement and the dagpart merge threshold with
    # costmodel.calibrate_weights (fitted, measured on the card, or analytic
    # on the CPU) instead of the analytic (1, 1, 1)
    calibrate_cost: bool = False

    def __post_init__(self):
        _check_choice("comm", self.comm, COMM_MODES)
        _check_choice("sched", self.sched, SCHED_MODES)
        _check_choice("partition", self.partition, STRATEGIES)
        if self.kernel_backend is not None:
            _check_choice("kernel_backend", self.kernel_backend, ops.BACKENDS)
        for name, lo in (("block_size", 1), ("tasks_per_device", 1), ("rhs_hint", 1),
                         ("merge_width", 1)):
            if int(getattr(self, name)) < lo:
                raise ValueError(f"{name} must be >= {lo}, got {getattr(self, name)}")
        if float(self.merge_cost) < 0:
            raise ValueError(f"merge_cost must be >= 0, got {self.merge_cost}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """Host-built execution plan: everything static for a (matrix, partition)."""

    bs: BlockStructure
    part: Partition
    config: SolverConfig
    n_devices: int
    n_levels: int
    # replicated
    diag: np.ndarray  # (nb+1, B, B) identity at pad slot
    owner: np.ndarray  # (nb+1,) int32, -1 at pad
    indeg: np.ndarray  # (nb+1,) int32 tile in-degree per block row
    ex_rows: np.ndarray  # (E,) ragged rows exchanged per level (levelset/zerocopy)
    ex_boundary: np.ndarray  # (n_boundary or 1,) boundary rows (syncfree/zerocopy)
    # ragged levelset schedules: flat arrays + per-level offsets + width buckets
    lvl_off: np.ndarray  # (T, 3) int32 start of level t in (solve, upd, ex) flats
    lvl_bucket: np.ndarray  # (T,) int32 index into `buckets`
    buckets: tuple  # ((ws, wu, we), ...) level widths, small set (<= MAX_BUCKETS)
    # sharded by leading device axis
    solve_rows: np.ndarray  # (D, S) ragged owned rows per level, pad -1 (levelset)
    upd_tiles: np.ndarray  # (D, U) ragged local tile ids per level, pad ML (levelset)
    local_rows: np.ndarray  # (D, MLR) owned rows, pad nb (syncfree)
    tile_row: np.ndarray  # (D, ML+1) dest block-row per local tile, pad nb
    tile_col: np.ndarray  # (D, ML+1) src block-col per local tile, pad nb
    tiles: np.ndarray  # (D, ML+1, B, B) zero tile at pad slot
    transpose: bool = False  # plan solves a^T x = b (built on reverse_transpose(a))
    # max (rows, tiles) any device schedules in one level — caps the syncfree
    # runtime frontier width ladder
    frontier_caps: tuple = (1, 1)
    # dagpart only: (n_steps+1,) level offsets of the merged supersteps.
    # None (levelset/syncfree) means the identity: one superstep per level.
    step_off: np.ndarray | None = None

    @property
    def n_supersteps(self) -> int:
        """Bulk-synchronous supersteps per solve: one per block level, or the
        merged step count for dagpart."""
        if self.step_off is not None:
            return max(0, len(self.step_off) - 1)
        return self.n_levels

    @property
    def n_boundary_rows(self) -> int:
        """Block rows that receive updates from a remote device."""
        return int(self.part.boundary.sum())

    @property
    def comm_bytes_per_solve(self) -> int:
        """Predicted collective payload bytes for one solve (one device's
        share); single-device plans execute no collectives and report 0."""
        if self.n_devices == 1:
            return 0
        B = self.bs.B
        itemsize = 4
        if self.config.comm == "unified":
            if self.n_boundary_rows == 0:
                return 0
            # syncfree additionally all-reduces the per-row in-degree counters
            width = B + 1 if self.config.sched == "syncfree" else B
            return (self.bs.nb + 1) * width * itemsize * self.n_supersteps
        if self.config.sched in LEVELSET_SCHEDS:
            # each boundary row is exchanged exactly once, before its level
            if self.n_boundary_rows == 0:
                return 0
            ex_width = np.asarray(self.buckets, dtype=np.int64)[self.lvl_bucket, 2]
            return int(ex_width.sum()) * B * itemsize
        return self.n_boundary_rows * (B + 1) * itemsize * self.n_supersteps


def _round_up_to(w: np.ndarray, base: int) -> np.ndarray:
    """Round each width up to the next power of ``base`` (0 stays 0)."""
    out = np.ones_like(w)
    while np.any(out < w):
        out = np.where(out < w, out * base, out)
    return np.where(w == 0, 0, out)


def _bucketize_levels(
    ws: np.ndarray, wu: np.ndarray, we: np.ndarray
) -> tuple[tuple, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Choose the per-level padded widths for the three ragged schedules.

    Widths round up a geometric ladder; the ladder coarsens (base 2 -> 4 -> 16)
    until the number of distinct (ws, wu, we) combos fits MAX_BUCKETS, and in
    the worst case degenerates to the single global-max bucket. Returns
    (buckets, bucket_id, bws, bwu, bwe).
    """
    T = ws.shape[0]
    if T == 0:
        # empty schedule: an all-zero bucket keeps every executor branch a no-op
        z = np.zeros(0, dtype=np.int64)
        return ((0, 0, 0),), np.zeros(0, np.int32), z, z, z
    for base in (2, 4, 16, 0):
        if base:
            bws, bwu, bwe = (_round_up_to(w, base) for w in (ws, wu, we))
        else:  # fallback: one global bucket per schedule (pad-to-max)
            bws, bwu, bwe = (
                np.where(w == 0, 0, max(1, int(w.max()))) for w in (ws, wu, we)
            )
        combos = np.unique(np.stack([bws, bwu, bwe], axis=1), axis=0)
        if combos.shape[0] <= MAX_BUCKETS:
            break
    key = {tuple(int(v) for v in c): i for i, c in enumerate(combos)}
    bucket_id = np.array(
        [key[(int(bws[t]), int(bwu[t]), int(bwe[t]))] for t in range(T)], np.int32
    )
    buckets = tuple(tuple(int(v) for v in c) for c in combos)
    return buckets, bucket_id, bws.astype(np.int64), bwu.astype(np.int64), bwe.astype(np.int64)


def _tiles_by_device(bs: BlockStructure, part: Partition, D: int) -> list:
    """Global tile ids resident on each device (tiles live on their column's
    owner) — the one definition of the device tile-store ordering, shared by
    :func:`build_plan` and :func:`refresh_plan`."""
    tile_dev = part.owner[bs.off_cols]
    return [np.nonzero(tile_dev == d)[0] for d in range(D)]


def build_plan(
    a: CSR, n_devices: int, config: SolverConfig = SolverConfig(),
    *, transpose: bool = False, part: Partition | None = None, device=None,
    verify: str | None = None,
) -> Plan:
    """Build the execution plan of ``a`` for ``n_devices`` devices.

    ``part`` reuses an existing partition computed for the same sparsity
    (e.g. a zero-fill factor shares its matrix's pattern). Not applicable to
    transpose plans, which are built on the reversed structure. ``device``
    (``None``: the card) is read only with ``config.calibrate_cost``: the
    device whose weights price the plan.

    ``verify`` runs the static plan verifier (:mod:`repro_torch.verify`)
    right after construction: a level name (``"basic"``/``"contracts"``/
    ``"strict"``) runs :func:`repro_torch.verify.verify_plan` at that level
    and raises :class:`repro_torch.verify.PlanVerificationError` on any
    finding of error grade (any finding at all for ``"strict"``). ``None``
    defers to the ``REPRO_TORCH_VERIFY`` environment variable (``1`` =
    strict, unset = off).
    """
    with get_tracer().span("sptrsv.schedule", n_devices=n_devices,
                           sched=config.sched, comm=config.comm,
                           transpose=transpose) as span:
        plan = _build_plan(a, n_devices, config, transpose=transpose, part=part,
                           device=device)
        span.set(n_levels=plan.n_levels, n_buckets=len(plan.buckets),
                 comm_bytes_per_solve=plan.comm_bytes_per_solve)
    # late import: the verifier walks plans, so it imports this module
    from repro_torch.verify import env_verify_level, verify_plan

    level = env_verify_level() if verify is None else verify
    if level is not None:
        verify_plan(plan, level=level).raise_if_failed()
    return plan


def _build_plan(a: CSR, n_devices: int, config: SolverConfig, *, transpose: bool,
                part: Partition | None, device) -> Plan:
    if transpose:
        # Solve a^T x = b with the forward-substitution machinery: reverse row
        # and column order of a^T, which is lower-triangular again; rhs and
        # solution are flipped at the Solver boundary.
        if part is not None:
            raise ValueError("partition reuse is not valid across reversal")
        a = reverse_transpose(a)
    bs = build_blocks(a, config.block_size)
    cost_weights = None
    if config.calibrate_cost and (config.partition == "malleable"
                                  or config.sched == "dagpart"):
        # calibrated weights drive malleable placement and/or the dagpart
        # merge pass's narrow-level threshold
        from repro_torch.core.costmodel import calibrate_weights

        cost_weights = calibrate_weights(config.block_size, config.kernel_backend,
                                         device=device)
    if part is None:
        part = make_partition(bs, n_devices, config.partition, config.tasks_per_device,
                              cost_weights=cost_weights, cost_R=config.rhs_hint)
    elif part.owner.shape[0] != bs.nb:
        raise ValueError("partition/block-structure mismatch")
    nb, B, D = bs.nb, bs.B, n_devices
    T = bs.n_block_levels

    diag = np.concatenate([bs.diag, np.eye(B, dtype=np.float32)[None]], axis=0)
    owner = np.concatenate([part.owner, [-1]]).astype(np.int32)
    indeg = np.concatenate([bs.block_indeg, [0]]).astype(np.int32)

    # --- per-device tile stores (tiles live on their column's owner) ---
    tile_dev = part.owner[bs.off_cols]
    per_dev_tiles = _tiles_by_device(bs, part, D)
    ML = max((t.shape[0] for t in per_dev_tiles), default=0)
    tiles = np.zeros((D, ML + 1, B, B), dtype=np.float32)
    tile_row = np.full((D, ML + 1), nb, dtype=np.int32)
    tile_col = np.full((D, ML + 1), nb, dtype=np.int32)
    local_tile_id = np.full(bs.n_tiles, -1, dtype=np.int64)  # global tile -> local slot
    for d, ids in enumerate(per_dev_tiles):
        k = ids.shape[0]
        tiles[d, :k] = bs.off_tiles[ids]
        tile_row[d, :k] = bs.off_rows[ids]
        tile_col[d, :k] = bs.off_cols[ids]
        local_tile_id[ids] = np.arange(k)

    # --- compacted levelset schedules (ragged flats + width buckets) ---
    lvl = bs.block_level
    rows_by = [[np.nonzero((part.owner == d) & (lvl == t))[0] for t in range(T)]
               for d in range(D)]
    col_lvl = lvl[bs.off_cols]
    tiles_by = [
        [np.nonzero((tile_dev == d) & (col_lvl == t))[0] for t in range(T)] for d in range(D)
    ]
    b_rows = np.nonzero(part.boundary)[0]
    per_level_ex = [b_rows[lvl[b_rows] == t] for t in range(T)]
    # dagpart: coarsen the level range into merged supersteps, then hoist each
    # merge group's exchange rows into the group's FIRST level slice
    step_off = None
    if config.sched == "dagpart":
        step_off = merge_levels(
            bs, part, merge_width=config.merge_width,
            merge_cost=config.merge_cost, cost_weights=cost_weights,
            cost_R=config.rhs_hint,
        )
        ex_by_level = [np.zeros(0, dtype=b_rows.dtype) for _ in range(T)]
        for k in range(len(step_off) - 1):
            g, h = int(step_off[k]), int(step_off[k + 1])
            ex_by_level[g] = (np.concatenate(per_level_ex[g:h])
                              if h - g > 1 else per_level_ex[g])
    else:
        ex_by_level = per_level_ex

    # per-level required widths (max over devices for the sharded schedules)
    ws = np.array([max(rows_by[d][t].shape[0] for d in range(D)) for t in range(T)],
                  dtype=np.int64) if T else np.zeros(0, np.int64)
    wu = np.array([max(tiles_by[d][t].shape[0] for d in range(D)) for t in range(T)],
                  dtype=np.int64) if T else np.zeros(0, np.int64)
    we = np.array([e.shape[0] for e in ex_by_level], dtype=np.int64)
    buckets, lvl_bucket, bws, bwu, bwe = _bucketize_levels(ws, wu, we)

    lvl_off = np.zeros((T, 3), dtype=np.int32)
    if T:
        lvl_off[:, 0] = np.concatenate([[0], np.cumsum(bws)[:-1]])
        lvl_off[:, 1] = np.concatenate([[0], np.cumsum(bwu)[:-1]])
        lvl_off[:, 2] = np.concatenate([[0], np.cumsum(bwe)[:-1]])
    S = max(1, int(bws.sum())) if T else 1
    U = max(1, int(bwu.sum())) if T else 1
    E = max(1, int(bwe.sum())) if T else 1
    solve_rows = np.full((D, S), -1, dtype=np.int32)
    upd_tiles = np.full((D, U), ML, dtype=np.int32)
    ex_rows = np.full((E,), nb, dtype=np.int32)
    for t in range(T):
        for d in range(D):
            r = rows_by[d][t]
            solve_rows[d, lvl_off[t, 0]: lvl_off[t, 0] + r.shape[0]] = r
            ids = tiles_by[d][t]
            upd_tiles[d, lvl_off[t, 1]: lvl_off[t, 1] + ids.shape[0]] = local_tile_id[ids]
        e = ex_by_level[t]
        ex_rows[lvl_off[t, 2]: lvl_off[t, 2] + e.shape[0]] = e
    ex_boundary = b_rows.astype(np.int32) if b_rows.size else np.full((1,), nb, dtype=np.int32)

    # --- syncfree plan ---
    per_dev_rows = [np.nonzero(part.owner == d)[0] for d in range(D)]
    MLR = max((r.shape[0] for r in per_dev_rows), default=1) or 1
    local_rows = np.full((D, MLR), nb, dtype=np.int32)
    for d, r in enumerate(per_dev_rows):
        local_rows[d, : r.shape[0]] = r

    return Plan(
        bs=bs, part=part, config=config, n_devices=D, n_levels=T,
        diag=diag, owner=owner, indeg=indeg, ex_rows=ex_rows,
        ex_boundary=ex_boundary, lvl_off=lvl_off, lvl_bucket=lvl_bucket,
        buckets=buckets, solve_rows=solve_rows, upd_tiles=upd_tiles,
        local_rows=local_rows, tile_row=tile_row, tile_col=tile_col, tiles=tiles,
        transpose=transpose,
        frontier_caps=(max(1, int(ws.max())) if T else 1,
                       max(1, int(wu.max())) if T else 1),
        step_off=step_off,
    )


def refresh_plan(plan: Plan, a: CSR) -> Plan:
    """Numeric refresh: a new :class:`Plan` carrying ``a``'s values on
    ``plan``'s exact pattern, partition and compacted schedules, bit-identical
    to what a fresh :func:`build_plan` on the same pattern would produce.
    Transpose plans refresh through the same reversal they were built with."""
    with get_tracer().span("sptrsv.refresh", transpose=plan.transpose,
                           n_devices=plan.n_devices):
        if plan.transpose:
            a = reverse_transpose(a)
        bs = refresh_block_values(plan.bs, a)
        B, D = bs.B, plan.n_devices
        diag = np.concatenate([bs.diag, np.eye(B, dtype=np.float32)[None]], axis=0)
        tiles = np.zeros_like(plan.tiles)
        for d, ids in enumerate(_tiles_by_device(bs, plan.part, D)):
            tiles[d, : ids.shape[0]] = bs.off_tiles[ids]
        return dataclasses.replace(plan, bs=bs, diag=diag, tiles=tiles)


def plan_from_arrays(fields: dict) -> Plan:
    """Build a :class:`Plan` from plain values keyed by field name.

    Plan fields go by their own names (``"diag"``, ``"lvl_off"``, ...), the
    nested records' fields by a prefix: ``"bs.<field>"`` for
    :class:`BlockStructure`, ``"part.<field>"`` for :class:`Partition`,
    ``"config.<field>"`` for :class:`SolverConfig`. ``step_off`` may be
    ``None``. Values are copied into fresh numpy arrays (or ints/tuples), so
    a plan built by another implementation carries over without sharing
    memory with it.
    """
    def arr(x):
        return None if x is None else np.array(x)

    def group(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in fields.items() if k.startswith(prefix)}

    bs_f = group("bs.")
    bs = BlockStructure(
        n=int(bs_f["n"]), B=int(bs_f["B"]), nb=int(bs_f["nb"]),
        **{k: arr(bs_f[k]) for k in ("diag", "off_rows", "off_cols", "off_tiles",
                                     "block_level", "block_indeg")})
    part_f = group("part.")
    part = Partition(
        n_devices=int(part_f["n_devices"]), strategy=str(part_f["strategy"]),
        tasks_per_device=int(part_f["tasks_per_device"]),
        owner=arr(part_f["owner"]), boundary=arr(part_f["boundary"]))
    config = SolverConfig(**group("config."))
    return Plan(
        bs=bs, part=part, config=config,
        n_devices=int(fields["n_devices"]), n_levels=int(fields["n_levels"]),
        buckets=tuple(tuple(int(v) for v in b) for b in fields["buckets"]),
        transpose=bool(fields["transpose"]),
        frontier_caps=tuple(int(v) for v in fields["frontier_caps"]),
        step_off=arr(fields["step_off"]),
        **{k: arr(fields[k]) for k in (
            "diag", "owner", "indeg", "ex_rows", "ex_boundary", "lvl_off",
            "lvl_bucket", "solve_rows", "upd_tiles", "local_rows", "tile_row",
            "tile_col", "tiles")},
    )


# ---------------------------------------------------------------------------
# schedule statistics
# ---------------------------------------------------------------------------


def level_widths(plan: Plan) -> np.ndarray:
    """(T, 3) per-level (solve, update, exchange) bucket widths."""
    return np.asarray(plan.buckets, dtype=np.int64)[plan.lvl_bucket]


def step_offsets(plan: Plan) -> np.ndarray:
    """(n_steps + 1,) level offsets of the plan's supersteps. Identity
    (one level per superstep) for levelset/syncfree; the merge pass's
    coarsening for dagpart."""
    if plan.step_off is not None:
        return np.asarray(plan.step_off, dtype=np.int32)
    return np.arange(plan.n_levels + 1, dtype=np.int32)


def step_widths(plan: Plan) -> np.ndarray:
    """(n_steps, 3) per-superstep (solve, update, exchange) schedule widths —
    each superstep's contiguous flat slice sums its levels' bucket widths."""
    wid = level_widths(plan)
    so = step_offsets(plan).astype(np.int64)
    cs = np.zeros((plan.n_levels + 1, 3), dtype=np.int64)
    np.cumsum(wid, axis=0, out=cs[1:])
    return cs[so[1:]] - cs[so[:-1]]


def fused_segments(plan: Plan) -> np.ndarray:
    """(n_seg, 2) ``[lo, hi)`` level ranges, one fused launch each: the
    schedule splits before every level whose boundary rows must be combined
    (zerocopy), at every superstep (unified with a cut), and not at all on
    one device or an empty cut."""
    T = plan.n_levels
    if T == 0:
        return np.zeros((0, 2), dtype=np.int32)
    cfg = plan.config
    if cfg.comm == "unified" and plan.n_devices > 1 and plan.n_boundary_rows > 0:
        so = step_offsets(plan)
        return np.stack([so[:-1], so[1:]], axis=1).astype(np.int32)
    wid = level_widths(plan)
    starts = [0]
    if cfg.comm == "zerocopy" and plan.n_devices > 1 and plan.n_boundary_rows > 0:
        starts += [t for t in range(1, T) if wid[t, 2] > 0]
    starts = np.unique(np.asarray(starts, dtype=np.int32))
    his = np.concatenate([starts[1:], [T]]).astype(np.int32)
    return np.stack([starts, his], axis=1)


# ---------------------------------------------------------------------------
# resident or streamed: kernel_backend="fused_streamed", or "fused" above the limit
# ---------------------------------------------------------------------------

# The reference's resident megakernel holds the diag/tile stores in a TPU
# core's VMEM and streams them above a VMEM budget. The port's resident
# kernel reads the stores from HBM (a per-warp prefetch ring in shared
# memory), so nothing forces streaming on Hopper; the choice is speed alone.
# The limit is in resident store bytes (resident_store_bytes), the quantity
# that grows with the plan: the store of the smallest plan from which the
# streamed form is no slower at every larger plan measured. Measured by
# perf/stream_crossover.py (resident against streamed device ms per solve,
# CUDA events, 20 solves, grid2d_factor(side, seed=6)) on an NVIDIA H100
# 80GB HBM3 at 700.00 W: streamed / resident was 0.79-0.89 at every side
# from 32 to 512 for B = 16 and B = 32 and at side 1024 for B = 32 (stores
# of 0.16 MB to 398 MB). Resident won at no size, so the limit is 0: "fused"
# streams every plan whose tile fits the streamed kernel (PERF.md section 6).
DEFAULT_STREAM_LIMIT = 0
ENV_STREAM_LIMIT = "REPRO_TORCH_STREAM_LIMIT"


def stream_limit() -> int:
    """Resident store bytes above which ``kernel_backend="fused"`` runs the
    streamed megakernel.

    Resolution order: the ``REPRO_TORCH_STREAM_LIMIT`` env override (an
    int; raise it to keep ``fused`` resident, lower it to make it stream),
    then the crossover calibrated from the card's probe solves
    (:func:`repro_torch.obs.calibration.calibrated_stream_limit`: paired
    ``fused`` / ``fused_streamed`` samples scale the default by their
    measured time ratio), then :data:`DEFAULT_STREAM_LIMIT`."""
    env = os.environ.get(ENV_STREAM_LIMIT)
    if env is not None:
        return int(env)
    from repro_torch.obs.calibration import calibrated_stream_limit

    lim = calibrated_stream_limit()
    return DEFAULT_STREAM_LIMIT if lim is None else lim


def resident_store_bytes(plan: Plan) -> int:
    """Bytes of the ``diag`` and ``tiles`` stores the resident megakernel
    reads (the reference's resident ``store`` term)."""
    return int(plan.diag.nbytes + plan.tiles.nbytes)


def stream_widths(plan: Plan) -> tuple[tuple, tuple]:
    """The reference's static DMA ladders: the distinct per-superstep
    (solve, update) schedule widths (:func:`step_widths`). The Hopper kernel
    needs no ladder (a bulk copy's size is a runtime value); kept for
    parity with the reference and its verifier."""
    if plan.n_levels == 0:
        return (0,), (0,)
    wid = step_widths(plan)
    return (tuple(sorted({int(w) for w in wid[:, 0]})),
            tuple(sorted({int(w) for w in wid[:, 1]})))


def streamed_stores(plan: Plan) -> tuple[np.ndarray, np.ndarray]:
    """The reference's schedule-ordered ``(diag_sched, tiles_sched)`` stores:
    ``diag_sched[d, k]`` is the diagonal tile of ``solve_rows[d, k]`` (the
    identity for a pad slot) and ``tiles_sched[d, k]`` the tile of slot
    ``upd_tiles[d, k]``. The Hopper kernel streams its own store instead
    (:func:`repro_torch.kernels.superstep.streamed_layout`: each row's
    incoming tiles beside its diagonal tile, in the order a warp uses them);
    kept for parity with the reference and its verifier."""
    nb = plan.bs.nb
    safe = np.where(plan.solve_rows < 0, nb, plan.solve_rows)  # (D, S)
    diag_sched = np.ascontiguousarray(plan.diag[safe])
    tiles_sched = np.ascontiguousarray(
        np.stack([plan.tiles[d][plan.upd_tiles[d]]
                  for d in range(plan.n_devices)]))
    return diag_sched, tiles_sched


def fused_layout(plan: Plan, d: int = 0) -> "superstep.StreamedLayout":
    """Device ``d``'s streamed layout of the whole schedule as one launch
    (:func:`repro_torch.kernels.superstep.streamed_layout`)."""
    return superstep.streamed_layout(
        [0, plan.n_supersteps], plan.lvl_off, level_widths(plan), plan.solve_rows[d],
        plan.upd_tiles[d], plan.tile_row[d], plan.tile_col[d], n_rows=plan.bs.nb + 1,
        stp=step_offsets(plan))


def fused_layouts(plan: Plan) -> list:
    """:func:`fused_layout` of every device."""
    return [fused_layout(plan, d) for d in range(plan.n_devices)]


def fused_vmem_bytes(plan: Plan, *, streamed: bool = False,
                     layouts: list | None = None) -> int:
    """On-chip bytes of one fused launch, by the port's Hopper rule: the
    megakernel's dynamic shared memory per CTA.

    Resident: :func:`repro_torch.kernels.superstep.shared_bytes` (a ring of
    three prefetch stages and three columns of B floats per warp), whatever
    the plan's size
    or the panel width (a panel column is a work item of its own).
    Streamed: :func:`repro_torch.kernels.superstep.streamed_shared_bytes`,
    two stages of the widest work item (a row's incoming tiles and its
    diagonal tile) per warp, on the busiest device; at ``B >= 170``, where
    two stages of one whole tile do not fit, one set of two stages of
    ``rows`` padded tile rows that the CTA's warps share. ``layouts`` is
    :func:`fused_layouts` of ``plan`` where the caller has it already.
    """
    B = plan.bs.B
    if not streamed:
        return superstep.shared_bytes(B)
    most = max(layout.max_item_tiles for layout in (layouts or fused_layouts(plan)))
    return superstep.streamed_shared_bytes(B, most)


def stream_dma_bytes_per_solve(plan: Plan, R: int = 1, *,
                               layouts: list | None = None) -> int:
    """Bytes the streamed megakernel copies into shared memory per solve of
    an ``R``-column right-hand side, on the busiest device: every live work
    item's store entries (its incoming tiles and its diagonal tile, rows
    padded to B + 1 floats), once per column, since each column's warp
    copies its own. Cutting a tile into row chunks (``B >= 170``) changes
    the number of copies, not the bytes: the chunks cover each entry once.
    ``layouts`` as for :func:`fused_vmem_bytes`."""
    if plan.n_levels == 0:
        return 0
    entries = max(layout.copied_entries for layout in (layouts or fused_layouts(plan)))
    return R * entries * 4 * superstep.stream_tile_floats(plan.bs.B)


def fused_streaming(plan: Plan, R: int | None = None) -> bool:
    """Whether ``plan``'s fused levelset executor uses the streamed store:
    always for ``kernel_backend="fused_streamed"``; for ``"fused"`` when
    :func:`resident_store_bytes` exceeds :func:`stream_limit`, at every
    block size. At ``B >= 170`` the streamed kernel copies each tile in row
    chunks; measured on an H100 (``chip_smoke.py`` phase 14,
    ``grid2d_factor(512)``, ms per launch) it is still the faster form:
    74.78 against the resident kernel's 415.29 at B = 176, 40.91 against
    241.23 at B = 256. Never for syncfree plans (the frontier form makes
    per-op calls). ``R`` is accepted for the reference's signature; the port's
    rule does not depend on it (the stores do not grow with the panel
    width)."""
    if plan.config.sched not in LEVELSET_SCHEDS:
        return False
    backend = plan.config.kernel_backend
    if backend == "fused_streamed":
        return True
    return backend == "fused" and resident_store_bytes(plan) > stream_limit()


def schedule_table_bytes(plan: Plan) -> int:
    """Bytes of the host-built schedule tables the executors index."""
    arrs = [plan.lvl_off, plan.lvl_bucket, plan.solve_rows, plan.upd_tiles,
            plan.ex_rows, plan.ex_boundary, plan.local_rows,
            plan.tile_row, plan.tile_col]
    if plan.step_off is not None:
        arrs.append(plan.step_off)
    return int(sum(np.asarray(x).nbytes for x in arrs))


def dispatch_stats(plan: Plan) -> dict:
    """Predicted per-solve dispatch counts, with the reference's keys.

    ``switch_dispatches`` counts the switch executor's kernel dispatches
    (gather+TRSV and GEMV+scatter per level with work, plus exchanges);
    ``fused_launches`` the megakernel launches a fused plan makes;
    ``streamed``, ``fused_vmem_bytes`` and ``stream_dma_bytes`` follow the
    port's rule (:func:`fused_streaming`, :func:`fused_vmem_bytes`,
    :func:`stream_dma_bytes_per_solve` for a vector solve), not the
    reference's VMEM budget; they describe the whole schedule as one launch
    (a unified plan with a cut launches once per superstep and copies the
    same entries; its widest work item is no wider). ``supersteps`` is the
    bulk-synchronous step count, ``supersteps_levelset`` the unmerged block
    level count, ``superstep_reduction`` their ratio.
    """
    wid = level_widths(plan)
    cfg = plan.config
    has_ex = (cfg.comm == "zerocopy" and plan.n_devices > 1
              and plan.n_boundary_rows > 0)
    unified = (cfg.comm == "unified" and plan.n_devices > 1
               and plan.n_boundary_rows > 0)
    n_ex = (int((wid[:, 2] > 0).sum()) if has_ex
            else (plan.n_supersteps if unified else 0))
    switch = int(2 * (wid[:, 0] > 0).sum() + 2 * (wid[:, 1] > 0).sum()) + n_ex
    streamed = fused_streaming(plan)
    layouts = fused_layouts(plan) if streamed else None  # built once for both stats
    n_steps = plan.n_supersteps
    return {"switch_dispatches": switch, "fused_launches": int(len(fused_segments(plan))),
            "exchanges": n_ex, "streamed": streamed,
            "fused_vmem_bytes": fused_vmem_bytes(plan, streamed=streamed, layouts=layouts),
            "stream_dma_bytes": (stream_dma_bytes_per_solve(plan, layouts=layouts)
                                 if streamed else 0),
            "supersteps": n_steps,
            "supersteps_levelset": plan.n_levels,
            "superstep_reduction": (plan.n_levels / n_steps) if n_steps else 1.0,
            "schedule_table_bytes": schedule_table_bytes(plan)}


# ---------------------------------------------------------------------------
# switch executor
# ---------------------------------------------------------------------------


def _exchange_mode(plan: Plan) -> str | None:
    """How ``plan``'s executor exchanges: its ``comm`` mode with several
    devices and a non-empty cut (the reference's gate), else ``None`` (with
    an empty cut every update is local)."""
    if plan.n_devices > 1 and plan.n_boundary_rows > 0:
        return plan.config.comm
    return None


def _pull_rows(plan: Plan, levels, device: torch.device) -> list:
    """The packed exchange before each of ``levels``: a device view of its
    ``ex_rows`` slice (pad rows ``nb`` included, as the reference sums
    them), or ``None`` where its exchange bucket is empty."""
    ex = torch.from_numpy(plan.ex_rows.astype(np.int64)).to(device)
    widths = level_widths(plan)
    return [ex[int(plan.lvl_off[t, 2]):int(plan.lvl_off[t, 2]) + int(widths[t, 2])]
            if widths[t, 2] > 0 else None for t in levels]


def _range(name: str, on: bool):
    """A ``record_function`` range named ``name`` when ``on``, else none."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class _Schedule:
    """A plan's schedule on device ``rank`` as device tensors, built once per
    executor.

    ``safe`` maps pad rows (-1) to the pad slot ``nb`` and ``valid`` marks
    the real ones; ``urow``/``ucol`` are the update tiles' destination and
    source block rows. ``levels`` holds each level's (solve offset, solve
    width, update offset, update width) as Python ints, so the level loop
    slices without reading anything back from the device; ``steps`` each
    superstep's level range. ``mode`` is :func:`_exchange_mode`; under
    ``"zerocopy"``, ``pulls[t]`` holds level ``t``'s packed exchange rows
    (:func:`_pull_rows`), ``None`` for every level otherwise.
    """

    def __init__(self, plan: Plan, device: torch.device, rank: int = 0):
        self.mode = _exchange_mode(plan)
        self.pulls = (_pull_rows(plan, range(plan.n_levels), device)
                      if self.mode == "zerocopy" else [None] * plan.n_levels)
        nb = plan.bs.nb
        sr = plan.solve_rows[rank].astype(np.int64)
        ut = plan.upd_tiles[rank].astype(np.int64)

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        self.safe = dev(np.where(sr < 0, nb, sr))
        self.valid = dev(sr >= 0)
        self.ut = dev(ut)
        self.urow = dev(plan.tile_row[rank].astype(np.int64)[ut])
        self.ucol = dev(plan.tile_col[rank].astype(np.int64)[ut])
        widths = level_widths(plan)
        self.levels = [
            (int(plan.lvl_off[t, 0]), int(widths[t, 0]),
             int(plan.lvl_off[t, 1]), int(widths[t, 1]))
            for t in range(plan.n_levels)
        ]
        so = step_offsets(plan).tolist()
        self.steps = list(zip(so[:-1], so[1:]))


def _level_solve(sched: _Schedule, diag, b_pad, acc, x, s0: int, w_s: int,
                 backend: str, delta=None) -> None:
    safe = sched.safe[s0:s0 + w_s]
    rhs = b_pad[safe] - acc[safe]
    if delta is not None:  # the reference's order: (b - acc) - delta
        rhs = rhs - delta[safe]
    xs = ops.batched_block_trsv(diag[safe], rhs, backend=backend)
    valid = ops.bcast_trailing(sched.valid[s0:s0 + w_s], xs)
    x[safe] = torch.where(valid, xs, x[safe])


def _tile_update(sched: _Schedule, tiles, acc, x, u0: int, w_u: int, backend: str,
                 group: int) -> None:
    tids = sched.ut[u0:u0 + w_u]
    prods = ops.batched_block_gemv(tiles[tids], x[sched.ucol[u0:u0 + w_u]],
                                   backend=backend, group=group)
    acc.index_add_(0, sched.urow[u0:u0 + w_u], prods)


def _run_levels(sched: _Schedule, diag: torch.Tensor, tiles: torch.Tensor,
                b_pad: torch.Tensor, backend: str, group: int,
                exchange=None) -> torch.Tensor:
    """The switch executor's level loop (``_compact_level_body`` of the
    reference) on padded blocks ``b_pad`` (nb+1, B[, R]); returns ``x``.
    Under ``sched.mode == "zerocopy"`` each level with exchange rows first
    runs ``exchange(acc, rows)``, the packed sum of those rows (the
    reference's ``_levelset_device_fn``). Under ``"unified"`` it runs
    superstep by superstep, ``exchange(acc, delta)`` first, then the step's
    levels with updates into ``delta`` and solves of ``(b - acc) - delta``
    (the reference's ``_levelset_unified_device_fn``). Each level's solve
    and update, and each exchange, run inside ``sptrsv.level_solve`` /
    ``sptrsv.tile_update`` / ``sptrsv.exchange`` ranges only when
    :func:`executor_scopes` says so (read once per solve)."""
    acc = torch.zeros_like(b_pad)
    x = torch.zeros_like(b_pad)
    unified = sched.mode == "unified"
    delta = torch.zeros_like(b_pad) if unified else None
    scoped = executor_scopes()
    for t0, t1 in (sched.steps if unified else [(0, len(sched.levels))]):
        if unified:
            with _range("sptrsv.exchange", scoped):
                exchange(acc, delta)
        for t in range(t0, t1):
            s0, w_s, u0, w_u = sched.levels[t]
            if sched.pulls[t] is not None:
                with _range("sptrsv.exchange", scoped):
                    exchange(acc, sched.pulls[t])
            if w_s > 0:
                with _range("sptrsv.level_solve", scoped):
                    _level_solve(sched, diag, b_pad, acc, x, s0, w_s, backend, delta)
            if w_u > 0:
                with _range("sptrsv.tile_update", scoped):
                    _tile_update(sched, tiles, acc if delta is None else delta, x, u0, w_u,
                                 backend, group)
    return x


class _FusedSchedule:
    """A plan's megakernel launches on device ``rank``, built once per
    executor: the reference's tables for the whole solve (``seg = [0,
    n_supersteps]``) as int32 device tensors and, on a card, the resident
    kernel's pull table (:func:`repro_torch.kernels.superstep.superstep_table`),
    or, for the streamed form, its layout
    (:func:`~repro_torch.kernels.superstep.streamed_layout`) and, once values
    are loaded, the streamed store; and the launches'
    :class:`~repro_torch.kernels.superstep.ReadyFlags` scratch, allocated
    once and kept from solve to solve.

    A plan that exchanges (:func:`_exchange_mode`) launches the split form
    once per :func:`fused_segments` range instead (``split``): one per
    superstep under ``"unified"``, one from each level with exchange rows
    under ``"zerocopy"``, whose packed rows before launch ``l`` are
    ``pulls[l]``. ``segs[l]`` is launch ``l``'s ``seg`` and the layout a
    :func:`~repro_torch.kernels.superstep.segmented_layout` of the whole
    solve cut at the launches (built on the CPU only for the streamed
    store)."""

    def __init__(self, plan: Plan, device: torch.device, streamed: bool, rank: int = 0):
        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)

        host = ([0, plan.n_supersteps], plan.lvl_off, level_widths(plan),
                plan.solve_rows[rank], plan.upd_tiles[rank], plan.tile_row[rank],
                plan.tile_col[rank])
        so = step_offsets(plan)
        self.tables = tuple(dev(t) for t in host)
        self.stp = dev(so)
        self.mode = _exchange_mode(plan)
        self.split = self.mode is not None
        self.table = self.layout = self.values = None
        self.flags = superstep.ReadyFlags(plan.bs.nb + 1, device)
        if streamed:
            superstep.check_streamed_fits(plan.bs.B)
        if self.split:
            # each launch's superstep range: segments start at superstep starts
            segs = fused_segments(plan)
            step_of = np.repeat(np.arange(plan.n_supersteps), np.diff(so))
            lo, hi = step_of[segs[:, 0]], step_of[segs[:, 1] - 1] + 1
            self.segs = dev(np.stack([lo, hi - lo], axis=1))
            self.pulls = (_pull_rows(plan, segs[:, 0], device) if self.mode == "zerocopy"
                          else [None] * len(segs))
            if streamed or device.type == "cuda":
                self.layout = superstep.segmented_layout(
                    *host[1:], n_rows=plan.bs.nb + 1, stp=so,
                    bounds=np.concatenate([lo, [plan.n_supersteps]])).to(device)
        elif streamed:
            self.layout = fused_layout(plan, rank).to(device)
        elif device.type == "cuda":
            self.table = superstep.superstep_table(
                *host, n_rows=plan.bs.nb + 1, stp=so).to(device)
        self.streamed = streamed

    def load(self, diag: torch.Tensor, tiles: torch.Tensor) -> None:
        """(Re)build the streamed store from new values."""
        if self.streamed:
            self.values = superstep.streamed_values(self.layout, diag, tiles)

    def run(self, diag: torch.Tensor | None, tiles: torch.Tensor | None,
            b_pad: torch.Tensor, exchange=None) -> torch.Tensor:
        """One megakernel launch over the whole schedule, or, split, one per
        segment, each after its exchange; returns ``x`` (the streamed form
        reads only its store: ``diag``/``tiles`` unused)."""
        scoped = executor_scopes()
        if self.split:
            return self._run_split(diag, tiles, b_pad, exchange, scoped)
        zeros = torch.zeros_like(b_pad)
        with _range("sptrsv.superstep", scoped):
            if self.streamed:
                _, x = superstep.superstep_streamed_call(
                    *self.tables, self.values, b_pad, zeros, zeros, stp=self.stp,
                    layout=self.layout, flags=self.flags)
            else:
                _, x = superstep.superstep_call(*self.tables, diag, tiles, b_pad, zeros, zeros,
                                                stp=self.stp, table=self.table, flags=self.flags)
        return x

    def _run_split(self, diag, tiles, b_pad, exchange, scoped: bool) -> torch.Tensor:
        """The multi-device fused executor: per launch the exchange, then
        one split launch on the carries, which stay in place. Unified:
        ``exchange(acc, delta)``. Zerocopy: ``exchange(delta, rows)`` where
        the launch starts at a level with exchange rows; ``delta`` carries
        the reference's accumulator and ``acc`` stays zero, so each solve's
        ``(b - 0) - delta`` is the unsplit ``b - acc`` bit for bit (``-0.0``
        included)."""
        acc, delta, x = (torch.zeros_like(b_pad) for _ in range(3))
        rest = self.tables[1:]
        for s in range(self.segs.shape[0]):
            if self.mode == "unified":
                with _range("sptrsv.exchange", scoped):
                    exchange(acc, delta)
            elif self.pulls[s] is not None:
                with _range("sptrsv.exchange", scoped):
                    exchange(delta, self.pulls[s])
            table = None if self.layout is None else self.layout.segments[s]
            with _range("sptrsv.superstep", scoped):
                if self.streamed:
                    superstep.superstep_streamed_split_(
                        self.segs[s], *rest, self.values, b_pad, acc, delta, x, self.stp,
                        layout=self.layout, table=table, flags=self.flags)
                else:
                    superstep.superstep_split_(self.segs[s], *rest, diag, tiles, b_pad, acc,
                                               delta, x, self.stp, table=table,
                                               flags=self.flags)
        return x


# ---------------------------------------------------------------------------
# syncfree executor
# ---------------------------------------------------------------------------


def _frontier_ladder(cap: int) -> tuple:
    """Geometric width ladder ``1, b, b², ..., cap`` for the runtime frontier;
    the base coarsens (2 -> 4 -> 16) until the ladder fits MAX_BUCKETS."""
    cap = max(1, int(cap))
    for base in (2, 4, 16):
        lad = sorted({cap} | {base ** k for k in range(64) if base ** k < cap})
        if len(lad) <= MAX_BUCKETS:
            return tuple(int(w) for w in lad)
    return (cap,)


class _SyncfreeSchedule:
    """A syncfree plan's tables on device ``rank`` as device tensors, built
    once per executor (the reference's ``_syncfree_device_fn``).

    ``lr`` are the local rows (pad ``nb``), ``lown`` marks the ones this
    rank owns and ``indeg`` holds their tile in-degrees; ``trow``/``tcol``
    are every local tile's destination and source block row, the zero tile
    at the pad slot ``MLT - 1`` (both ``nb``), and ``tmine`` marks the tiles
    whose destination this rank owns. ``mode`` is :func:`_exchange_mode`:
    with one, updates into another rank's rows go to ``delta``/``dcnt`` and
    each sweep ends with an exchange, of the boundary rows ``exb`` alone
    under ``"zerocopy"``. ``frontier`` selects the frontier-bucketed form,
    whose solve and update widths round up the ladders ``lad_s`` /
    ``lad_u``. ``sweeps`` and ``host_reads`` count the last solve's sweeps
    and device-to-host reads.
    """

    def __init__(self, plan: Plan, device: torch.device, frontier: bool, rank: int = 0):
        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        lr = plan.local_rows[rank].astype(np.int64)
        trow = plan.tile_row[rank].astype(np.int64)
        self.nb, self.frontier, self.mode = plan.bs.nb, frontier, _exchange_mode(plan)
        self.lr, self.lown, self.indeg = dev(lr), dev(plan.owner[lr] == rank), dev(plan.indeg[lr])
        self.trow, self.tcol = dev(trow), dev(plan.tile_col[rank].astype(np.int64))
        self.tmine = dev(plan.owner[trow] == rank)
        self.exb = dev(plan.ex_boundary.astype(np.int64))
        mlr, mlt = lr.shape[0], plan.tiles.shape[1]
        self.iota_l = torch.arange(mlr, device=device)
        self.iota_t = torch.arange(mlt, device=device)
        self.lad_s = _frontier_ladder(min(plan.frontier_caps[0], mlr))
        self.lad_u = _frontier_ladder(min(plan.frontier_caps[1], mlt))
        self.name = (f"syncfree plan (nb={self.nb}, B={plan.bs.B}, levels={plan.n_levels}, "
                     f"transpose={plan.transpose})")
        self.sweeps = self.host_reads = 0

    def width(self, ladder: tuple, count: int) -> int:
        """The smallest ladder width that holds ``count`` (the reference's
        ``lax.switch`` branch)."""
        k = bisect.bisect_left(ladder, count)
        if k == len(ladder):
            raise RuntimeError(f"{self.name}: a frontier of {count} exceeds its ladder "
                               f"{ladder}")
        return ladder[k]


def _apply_updates(s: _SyncfreeSchedule, carries: tuple, rows: torch.Tensor,
                   prods: torch.Tensor, counts: torch.Tensor, mine: torch.Tensor) -> None:
    """Add masked ``prods`` and ``counts`` at ``rows``: into ``acc``/``cnt``,
    or, with an exchange, those whose destination this rank owns (``mine``)
    there and the others into ``delta``/``dcnt``, in the reference's order."""
    acc, cnt, delta, dcnt = carries
    if s.mode is None:
        acc.index_add_(0, rows, prods)
        cnt.index_add_(0, rows, counts)
        return
    m = ops.bcast_trailing(mine, prods)
    acc.index_add_(0, rows, torch.where(m, prods, 0.0))
    cnt.index_add_(0, rows, torch.where(mine, counts, 0))
    delta.index_add_(0, rows, torch.where(m, 0.0, prods))
    dcnt.index_add_(0, rows, torch.where(mine, 0, counts))


def _run_syncfree(s: _SyncfreeSchedule, diag: torch.Tensor, tiles: torch.Tensor,
                  b_pad: torch.Tensor, backend: str, group: int,
                  combine=None) -> torch.Tensor:
    """The syncfree sweep loop on padded blocks ``b_pad`` (nb+1, B[, R]);
    returns ``x``. Each sweep solves the ready rows (owned, unsolved, every
    incoming tile counted), then applies the tiles whose source row it
    solved and counts them at their destination. A sweep solves exactly one
    block level, so a solve takes ``n_levels`` sweeps. On one device the
    host reads the sweep's counts once (the frontier's widths, and whether
    rows remain). On several, ``combine(acc, delta, cnt, dcnt, left)`` ends
    each sweep: the exchange, and the count of rows unsolved on every rank
    from this rank's ``left``, read on the host (the frontier form reads
    its widths before it). A sweep that solves no row on any rank raises.
    Each sweep runs inside a ``sptrsv.level_solve`` range, and its exchange
    inside ``sptrsv.exchange``, when :func:`executor_scopes` says so."""
    nb = s.nb
    acc, x = torch.zeros_like(b_pad), torch.zeros_like(b_pad)
    cnt = torch.zeros(nb + 1, dtype=torch.int32, device=b_pad.device)
    solved = torch.zeros(nb + 1, dtype=torch.bool, device=b_pad.device)
    delta = dcnt = None
    if s.mode is not None:
        delta, dcnt = torch.zeros_like(acc), torch.zeros_like(cnt)
    carries = (acc, cnt, delta, dcnt)
    if not s.frontier:
        ldiag, lb = diag[s.lr], b_pad[s.lr]
    remaining, s.sweeps, s.host_reads = nb, 0, 0  # every row is some rank's
    scoped = executor_scopes()  # read once per solve
    while remaining:
        if s.sweeps > nb:
            raise RuntimeError(f"{s.name}: {remaining} rows unsolved after {s.sweeps} sweeps")
        s.sweeps += 1
        with _range("sptrsv.level_solve", scoped):
            ready = s.lown & ~solved[s.lr] & (cnt[s.lr] == s.indeg)
            just = torch.zeros_like(solved)
            just[s.lr] = ready
            tmask = just[s.tcol]
            if s.frontier:
                n_ready, n_tiles = torch.stack([ready.sum(), tmask.sum()]).tolist()
                s.host_reads += 1
                if n_ready:
                    # compact the ready rows in ascending local index, pad MLR -> row nb
                    mlr = s.iota_l.shape[0]
                    order = torch.sort(torch.where(ready, s.iota_l, mlr)).values[
                        :s.width(s.lad_s, n_ready)]
                    valid = order < mlr
                    rows = torch.where(valid, s.lr[torch.where(valid, order, 0)], nb)
                    xs = ops.batched_block_trsv(diag[rows], b_pad[rows] - acc[rows],
                                                backend=backend)
                    x[rows] = torch.where(ops.bcast_trailing(valid, xs), xs, x[rows])
                solved |= just
                if n_tiles:
                    # compact the tiles sourced at this frontier, pad -> the zero tile
                    mlt = s.iota_t.shape[0]
                    tid = torch.sort(torch.where(tmask, s.iota_t, mlt)).values[
                        :s.width(s.lad_u, n_tiles)]
                    tvalid = tid < mlt
                    tid = torch.where(tvalid, tid, mlt - 1)
                    prods = ops.batched_block_gemv(tiles[tid], x[s.tcol[tid]], backend=backend,
                                                   group=group)
                    _apply_updates(s, carries, s.trow[tid],
                                   torch.where(ops.bcast_trailing(tvalid, prods), prods, 0.0),
                                   tvalid.to(torch.int32), s.tmine[tid])
            else:
                xs = ops.batched_block_trsv(ldiag, lb - acc[s.lr], backend=backend)
                x[s.lr] = torch.where(ops.bcast_trailing(ready, xs), xs, x[s.lr])
                solved |= just
                prods = ops.batched_block_gemv(tiles, x[s.tcol], backend=backend, group=group)
                _apply_updates(s, carries, s.trow,
                               torch.where(ops.bcast_trailing(tmask, prods), prods, 0.0),
                               tmask.to(torch.int32), s.tmine)
        if combine is not None:
            with _range("sptrsv.exchange", scoped):
                left = combine(acc, delta, cnt, dcnt, (s.lown & ~solved[s.lr]).sum())
            s.host_reads += 1
        elif s.frontier:
            left = remaining - n_ready
        else:
            left = remaining - int(ready.sum())
            s.host_reads += 1
        if left == remaining:
            raise RuntimeError(f"{s.name}: {remaining} rows unsolved and none ready "
                               f"at sweep {s.sweeps}")
        remaining = left
    return x


def check_executable(plan: Plan, group) -> int:
    """This process's device index in ``plan``. Raises ``ValueError`` for a
    multi-device plan without a ``group`` of ``n_devices`` ranks."""
    D = plan.n_devices
    if group is None:
        if D > 1:
            raise ValueError(f"a {D}-device plan runs on a torch.distributed group of {D} "
                             f"ranks, one per device: pass group=")
        return 0
    if comm.size(group) != D:
        raise ValueError(f"a {D}-device plan needs a group of {D} ranks, got "
                         f"{comm.size(group)}")
    return comm.rank(group)


def solve_local(plan: Plan, b_blocks: torch.Tensor) -> torch.Tensor:
    """Level-scheduled solve on ``b_blocks``' device. b_blocks: (nb, B) or
    (nb, B, R) -> x of the same shape."""
    return Solver(plan, b_blocks.device).solve_blocks(b_blocks)


class Solver:
    """SpTRSV executor for one plan on one device (the reference's
    ``DistributedSolver``, one process per device).

    Plan values and schedule live on ``device`` (``None`` means the card).
    Levelset and dagpart plans: ``kernel_backend="fused"`` and
    ``"fused_streamed"`` run each solve as one superstep megakernel launch,
    resident or streamed (the reference's ``solve_local`` fused branch); the
    other backends run the per-level switch executor. Syncfree plans run the
    syncfree executor: its dense scan under ``reference`` and ``cuda``, its
    frontier-bucketed form under the fused backends, whose block ops resolve
    by :func:`repro_torch.kernels.ops.op_backend` (the CUDA kernels on a
    card).

    A multi-device plan (``n_devices = D``) runs on a ``torch.distributed``
    ``group`` of ``D`` ranks, one process per device: each rank builds this
    executor on its own device with the same plan and runs device
    ``rank``'s tables, all ranks solve together, and each returns the whole
    ``x``. Levelset and dagpart under ``comm="zerocopy"``: the switch
    executor exchanges the packed rows of each level that has some, the
    fused backends launch the megakernel's split form once per exchange
    segment (:func:`fused_segments`), the rows exchanged before each
    launch. Under ``comm="unified"`` both exchange once per superstep, the
    fused backends launching the split form once per superstep. Syncfree
    plans exchange once per sweep (two ``all_reduce`` calls: values, then
    counts with the rows left) and take ``n_levels`` sweeps on every rank.
    With an empty cut nothing is exchanged (syncfree still sums the rows
    left once a sweep). ``exchanges`` counts the last solve's exchanges;
    with a ``group`` every solve ends with one more ``all_reduce``, the
    gather. A multi-device plan without a group of ``D`` ranks raises
    ``ValueError``. ``n_solves`` counts invocations; a multi-RHS panel
    counts once.
    """

    def __init__(self, plan: Plan, device: str | torch.device | None = None, group=None):
        self.device = resolve_device(device)
        self.backend = ops.executor_backend(plan.config.kernel_backend, self.device)
        self.rank = check_executable(plan, group)
        self.group = group
        self.plan = plan
        self.n_solves = self.exchanges = 0
        self._fused = self._sched = self._syncfree = None
        if plan.config.sched == "syncfree":
            self._syncfree = _SyncfreeSchedule(plan, self.device,
                                               self.backend in ops.FUSED_BACKENDS, self.rank)
        elif self.backend in ops.FUSED_BACKENDS:
            self._fused = _FusedSchedule(plan, self.device, fused_streaming(plan), self.rank)
        else:
            self._sched = _Schedule(plan, self.device, self.rank)
        self._exchange = {"unified": self._exchange_delta,
                          "zerocopy": self._exchange_rows}.get(_exchange_mode(plan))
        if plan.n_devices > 1:
            mask = (plan.owner == self.rank).astype(np.float32)  # this rank's rows, pad 0
            self._owner_mask = torch.from_numpy(mask).to(self.device)
        self._load_values(plan)

    def _exchange_delta(self, acc: torch.Tensor, delta: torch.Tensor) -> None:
        """The unified exchange: ``acc += all_reduce(delta)``, then
        ``delta = 0`` (the reference's ``psum`` of the split carry)."""
        acc += comm.all_reduce_sum_(delta, self.group)
        delta.zero_()
        self.exchanges += 1

    def _exchange_rows(self, carry: torch.Tensor, rows: torch.Tensor) -> None:
        """The zerocopy exchange: ``carry[rows] = all_reduce(carry[rows])``,
        one packed buffer of the level's boundary rows, pad rows included
        (the reference's ``psum(acc[rows])``)."""
        carry[rows] = comm.all_reduce_sum_(carry[rows], self.group)
        self.exchanges += 1

    def _combine_sweep(self, acc, delta, cnt, dcnt, left: torch.Tensor) -> int:
        """A multi-device syncfree sweep's end (the reference's steps 4 and
        5): the exchange, then the rows unsolved on every rank, read on the
        host. Zerocopy sums ``delta``/``dcnt`` at the boundary rows into
        ``acc``/``cnt`` and zeroes them there, unified every row; the counts
        travel with this rank's ``left`` in one int32 ``all_reduce``, so a
        sweep makes two, and one (``left`` alone) with an empty cut."""
        s = self._syncfree
        left = left.reshape(1).to(torch.int32)
        if s.mode is None:
            return int(comm.all_reduce_sum_(left, self.group))
        rows = s.exb if s.mode == "zerocopy" else slice(None)
        acc[rows] += comm.all_reduce_sum_(delta[rows].contiguous(), self.group)
        delta[rows] = 0.0
        counts = comm.all_reduce_sum_(torch.cat([dcnt[rows], left]), self.group)
        cnt[rows] += counts[:-1]
        dcnt[rows] = 0
        self.exchanges += 1
        return int(counts[-1])

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's own rows of ``x``, summed over the group: the whole
        ``x`` on every rank (the reference's ``psum(x * owner_mask)``)."""
        with _range("sptrsv.gather", executor_scopes()):
            if self.plan.n_devices > 1:
                x = x * ops.bcast_trailing(self._owner_mask, x)
            return comm.all_reduce_sum_(x, self.group)

    def _load_values(self, plan: Plan) -> None:
        diag = torch.from_numpy(plan.diag).to(self.device)
        tiles = torch.from_numpy(np.ascontiguousarray(plan.tiles[self.rank])).to(self.device)
        if self._fused is not None and self._fused.streamed:
            # the streamed kernel reads only its store: keep no second copy
            self._fused.load(diag, tiles)
            self._diag = self._tiles = None
        else:
            self._diag, self._tiles = diag, tiles

    def refresh(self, plan: Plan) -> None:
        """Swap in a numerically refreshed plan (:func:`refresh_plan`): the
        schedule tensors stay, only ``diag``/``tiles`` (or the streamed
        store built from them) are replaced, this rank's on a multi-device
        plan."""
        old = self.plan
        # a structurally different plan would pair new values with the old
        # schedule — reject it (never an assert: -O must not disable this)
        if not (plan.config == old.config and plan.n_devices == old.n_devices
                and plan.transpose == old.transpose
                and np.array_equal(plan.solve_rows, old.solve_rows)
                and np.array_equal(plan.lvl_off, old.lvl_off)
                and np.array_equal(step_offsets(plan), step_offsets(old))
                and np.array_equal(plan.local_rows, old.local_rows)
                and np.array_equal(plan.indeg, old.indeg)
                and np.array_equal(plan.tile_row, old.tile_row)):
            raise ValueError(
                "refresh requires an identical symbolic schedule (same "
                "pattern, config, and device count as the executor's plan)"
            )
        self.plan = plan
        self._load_values(plan)

    def solve_blocks(self, b_blocks: torch.Tensor) -> torch.Tensor:
        """b_blocks: (nb, B) or a multi-RHS panel (nb, B, R) -> same shape."""
        self.n_solves += 1
        self.exchanges = 0
        b_blocks = b_blocks.to(self.device, torch.float32)
        b_pad = torch.cat([b_blocks, b_blocks.new_zeros((1,) + b_blocks.shape[1:])])
        if self._fused is not None:
            x = self._fused.run(self._diag, self._tiles, b_pad, self._exchange)
        elif self._syncfree is not None:
            x = _run_syncfree(self._syncfree, self._diag, self._tiles, b_pad,
                              ops.op_backend(self.backend, self.device),
                              self.plan.config.gemv_group,
                              self._combine_sweep if self.plan.n_devices > 1 else None)
        else:
            x = _run_levels(self._sched, self._diag, self._tiles, b_pad,
                            self.backend, self.plan.config.gemv_group, self._exchange)
        if self.group is not None:
            x = self._gather(x)
        return x[: self.plan.bs.nb]

    def solve(self, b: np.ndarray) -> np.ndarray:
        """b: (n,) or (n, R) RHS panel -> x, as numpy. Transpose plans flip
        row order at this boundary (the plan was built on
        ``reverse_transpose(a)``)."""
        b = np.asarray(b, np.float32)
        if self.plan.transpose:
            b = b[::-1]
        b_blocks = torch.from_numpy(pad_rhs(b, self.plan.bs))
        x = unpad_x(self.solve_blocks(b_blocks).cpu().numpy(), self.plan.bs)
        return x[::-1].copy() if self.plan.transpose else x


def sptrsv(a: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
           config: SolverConfig = SolverConfig(), transpose: bool = False,
           group=None) -> np.ndarray:
    """Deprecated one-shot API: analyse, plan and solve ``L x = b`` (or
    ``L^T x = b``) on ``device`` (``None``: the card), on the ranks of
    ``group`` if one is given (a multi-device plan, one device per rank).

    A thin shim over :class:`repro_torch.api.SpTRSVContext`: it re-runs the
    whole analysis on every call, the cost the session amortizes. Hold a
    context and call ``ctx.solve(ctx.analyse(a), b)`` instead.
    """
    warnings.warn(
        "repro_torch.core.solver.sptrsv is deprecated: use "
        "repro_torch.api.SpTRSVContext (analyse once, factorize/solve many)",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.api import SpTRSVContext

    ctx = SpTRSVContext(device=device, options=config, group=group)
    return ctx.solve(ctx.analyse(a), b, transpose=transpose)
