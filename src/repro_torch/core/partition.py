"""Workload partitioning across devices — the paper's task-pool model (§V).

Three strategies over *block rows* (the schedulable unit):

* ``contiguous`` — the paper's baseline: block-rows split into D consecutive
  ranges. Dependencies become unidirectional (device d always waits on
  devices < d), the imbalance the paper identifies.
* ``taskpool``   — the paper's contribution: block-rows grouped into *tasks* of
  ``task_size`` consecutive block-rows, dealt **round-robin** to devices.
  ``tasks_per_device`` is the paper's tunable (Fig. 9 sensitivity).
* ``malleable``  — cost-model-driven task pool (paper Fig. 9 direction, plus
  the elasticity line of work): per-block-row cost = diagonal solve + the tile
  updates computed where that block column lives; each *level* is chopped into
  tasks of adaptive size (equal cost, not equal row count) and the tasks are
  placed greedily, largest first (LPT), onto the least-loaded device of that
  level. Ties within a small load slack go to the device that already owns the
  most predecessor tiles, keeping the boundary cut small. Because placement is
  per level, every wavefront is balanced by construction instead of relying on
  the round-robin deal to scatter a level's rows evenly.

Also computes the *cut statistics* that drive the zero-copy exchange: a block
row is a **boundary row** iff some tile in that row lives in a column owned by
a different device — only those rows are communicated.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.blocking import BlockStructure
from repro_torch.core.costmodel import merge_cost_threshold
from repro_torch.obs.trace import get_tracer

STRATEGIES = ("contiguous", "taskpool", "malleable")


@dataclasses.dataclass(frozen=True)
class Partition:
    n_devices: int
    strategy: str  # one of STRATEGIES
    tasks_per_device: int
    owner: np.ndarray  # (nb,) device owning each block row (and block column)
    boundary: np.ndarray  # (nb,) bool: row receives updates from a remote device

    def local_rows(self, d: int) -> np.ndarray:
        return np.nonzero(self.owner == d)[0].astype(np.int32)


DEFAULT_COST_WEIGHTS = (1.0, 1.0, 1.0)  # (w_solve, w_tile_mem, w_tile_flop)


def block_row_cost(
    bs: BlockStructure,
    *,
    weights: tuple = DEFAULT_COST_WEIGHTS,
    R: int = 1,
) -> np.ndarray:
    """Per-block-row work in block-op units for an R-wide RHS panel.

    Owning row r means one B×B diagonal solve plus one B×B product per tile in
    the row's *column* (tiles live on their column's owner). The minimal
    multi-RHS model splits the tile term into an R-independent load
    (``w_tile_mem`` — GEMM amortizes the tile fetch across the panel) and a
    per-RHS product term (``w_tile_flop``):

        cost = w_solve·R + (w_tile_mem + w_tile_flop·R) · tiles_in_column

    The defaults reproduce the analytic 1:2 TRSV:GEMV ratio at R=1
    (``1 + 2·tiles``); ``SolverConfig(calibrate_cost=True)`` passes
    ``costmodel.calibrate_weights`` instead.
    """
    w_solve, w_tile_mem, w_tile_flop = weights
    col_tiles = np.bincount(bs.off_cols, minlength=bs.nb)
    return w_solve * R + (w_tile_mem + w_tile_flop * R) * col_tiles


def _malleable_owner(
    bs: BlockStructure, n_devices: int, tasks_per_device: int,
    cost_weights: tuple = DEFAULT_COST_WEIGHTS, cost_R: int = 1,
) -> np.ndarray:
    nb, D = bs.nb, n_devices
    owner = np.full(nb, -1, dtype=np.int32)
    cost = block_row_cost(bs, weights=cost_weights, R=cost_R)
    lvl = bs.block_level
    # row -> predecessor block-columns (CSR over tiles), for placement affinity
    order = np.argsort(bs.off_rows, kind="stable")
    pre_cols = bs.off_cols[order]
    pre_ptr = np.zeros(nb + 1, dtype=np.int64)
    np.cumsum(np.bincount(bs.off_rows, minlength=nb), out=pre_ptr[1:])

    for t in range(bs.n_block_levels):
        rows_t = np.nonzero(lvl == t)[0]  # ascending: consecutive rows cluster
        if rows_t.size == 0:
            continue
        # malleable task sizing: chop the level into exactly n_tasks contiguous
        # tasks of (approximately) equal COST — dense rows travel alone, sparse
        # rows pool together. The target is re-derived from the remaining cost
        # so one oversized row cannot starve the trailing tasks.
        size = int(rows_t.size)
        n_tasks = int(min(size, D * tasks_per_device))
        level_cost = cost[rows_t]
        remaining = float(level_cost.sum())
        tasks = []
        i = 0
        for k in range(n_tasks):
            tgt = remaining / (n_tasks - k)
            j = i
            acc = 0.0
            # leave at least one row for each task still to be formed
            cap = size - (n_tasks - k - 1)
            while j < cap and (j == i or acc < tgt):
                acc += level_cost[j]
                j += 1
            tasks.append(rows_t[i:j])
            remaining -= acc
            i = j
        if i < size:  # numerical slack: sweep leftovers into the last task
            tasks[-1] = rows_t[i - tasks[-1].size:]
        task_cost = np.array([cost[tk].sum() for tk in tasks])

        # LPT within the level: heaviest task -> least-loaded device. Within a
        # small load slack of the minimum, prefer (fewest rows this level, most
        # owned predecessor tiles) — count balance is the metric the wavefront
        # pays for, the affinity term keeps the boundary cut small.
        load = np.zeros(D)
        rows_of = np.zeros(D, dtype=np.int64)
        slack = 0.25 * task_cost.mean()
        for i in np.argsort(task_cost, kind="stable")[::-1]:
            tk = tasks[i]
            cand = np.nonzero(load <= load.min() + slack)[0]
            if cand.size > 1:
                cand = cand[rows_of[cand] == rows_of[cand].min()]
            if cand.size > 1:
                pre = np.concatenate(
                    [pre_cols[pre_ptr[r]:pre_ptr[r + 1]] for r in tk]
                ).astype(np.int64)
                own = owner[pre] if pre.size else np.empty(0, np.int32)
                own = own[own >= 0]
                aff = np.bincount(own, minlength=D) if own.size else np.zeros(D, np.int64)
                cand = cand[aff[cand] == aff[cand].max()]
            d = cand[np.argmin(load[cand])]
            owner[tk] = d
            load[d] += task_cost[i]
            rows_of[d] += tk.size
    return owner


def make_partition(
    bs: BlockStructure,
    n_devices: int,
    strategy: str = "taskpool",
    tasks_per_device: int = 8,
    *,
    cost_weights: tuple | None = None,
    cost_R: int = 1,
) -> Partition:
    """``cost_weights``/``cost_R`` feed the malleable strategy's cost model
    (calibrated TRSV:GEMV weights and the expected RHS panel width); the
    row-count strategies ignore them. Runs inside the ``sptrsv.partition``
    span."""
    with get_tracer().span("sptrsv.partition", strategy=strategy,
                           n_devices=n_devices, nb=bs.nb) as span:
        part = _make_partition(bs, n_devices, strategy, tasks_per_device,
                               cost_weights=cost_weights, cost_R=cost_R)
        span.set(boundary_rows=int(part.boundary.sum()))
    return part


def _make_partition(bs: BlockStructure, n_devices: int, strategy: str,
                    tasks_per_device: int, *, cost_weights: tuple | None,
                    cost_R: int) -> Partition:
    nb = bs.nb
    if strategy == "contiguous":
        per = -(-nb // n_devices)
        owner = np.minimum(np.arange(nb) // per, n_devices - 1).astype(np.int32)
        tasks_per_device = 1
    elif strategy == "taskpool":
        n_tasks = n_devices * tasks_per_device
        task_size = max(1, -(-nb // n_tasks))
        task_of = np.arange(nb) // task_size
        owner = (task_of % n_devices).astype(np.int32)  # round-robin deal (paper §V)
    elif strategy == "malleable":
        owner = _malleable_owner(
            bs, n_devices, tasks_per_device,
            cost_weights=cost_weights or DEFAULT_COST_WEIGHTS, cost_R=cost_R,
        )
    else:
        raise ValueError(f"unknown partition strategy: {strategy!r} "
                         f"(expected one of {STRATEGIES})")

    boundary = np.zeros(nb, dtype=bool)
    remote = owner[bs.off_cols] != owner[bs.off_rows]
    boundary[bs.off_rows[remote]] = True
    return Partition(
        n_devices=n_devices, strategy=strategy, tasks_per_device=tasks_per_device,
        owner=owner, boundary=boundary,
    )


def remote_source_levels(bs: BlockStructure, part: Partition) -> np.ndarray:
    """(T,) max block level of any *remote* source column feeding each level
    (−1 when every tile landing in the level is device-local).

    This is the legality oracle for superstep merging: level ``t`` may join a
    merged superstep starting at level ``g`` iff ``remote_source_levels[t] <
    g`` — every cross-device contribution into ``t`` then solved in an
    *earlier* superstep, so the exchange at the group's start already carries
    it. Intra-device dependencies are unconstrained: the in-kernel rowsweep
    executes the group's levels in order.
    """
    T = bs.n_block_levels
    mrs = np.full(T, -1, dtype=np.int64)
    if part.n_devices <= 1 or T == 0:
        return mrs
    remote = part.owner[bs.off_cols] != part.owner[bs.off_rows]
    if not remote.any():
        return mrs
    lvl = bs.block_level
    np.maximum.at(mrs, lvl[bs.off_rows[remote]], lvl[bs.off_cols[remote]])
    return mrs


def merge_levels(
    bs: BlockStructure,
    part: Partition,
    *,
    merge_width: int = 64,
    merge_cost: float = 0.0,
    cost_weights: tuple | None = None,
    cost_R: int = 1,
) -> np.ndarray:
    """Greedy DAG-partition merge pass: coarsen the levelset schedule into
    supersteps. Returns ``(n_steps + 1,)`` int32 offsets into the level range
    — superstep ``s`` executes levels ``[off[s], off[s+1])`` in one grid step.

    Level ``t`` joins the running group (started at level ``g``) iff

    * **legality** — every remote source into ``t`` solves before ``g``
      (:func:`remote_source_levels`), so the group-start exchange already
      carries it;
    * **narrowness** — both the running group and ``t`` are launch-bound:
      busiest-device cost per level ≤ ``merge_cost`` (0 →
      :func:`repro_torch.core.costmodel.merge_cost_threshold`). Wide levels
      keep their own superstep — merging them would serialize real
      parallelism inside the kernel's sequential rowsweep;
    * **churn cap** — the busiest device's accumulated row count for the
      group stays ≤ ``merge_width``, bounding per-step schedule slices.
    """
    T = bs.n_block_levels
    if T == 0:
        return np.zeros(1, dtype=np.int32)
    weights = cost_weights or DEFAULT_COST_WEIGHTS
    if merge_cost <= 0:
        merge_cost = merge_cost_threshold(weights, R=cost_R)
    cost = block_row_cost(bs, weights=weights, R=cost_R)
    lvl = bs.block_level
    # busiest-device cost and row count per level
    lvl_cost = np.zeros(T)
    lvl_rows = np.zeros(T, dtype=np.int64)
    for d in range(part.n_devices):
        mine = part.owner == d
        if mine.any():
            lvl_cost = np.maximum(lvl_cost, np.bincount(
                lvl[mine], weights=cost[mine], minlength=T)[:T])
            lvl_rows = np.maximum(lvl_rows, np.bincount(
                lvl[mine], minlength=T)[:T])
    mrs = remote_source_levels(bs, part)

    starts = [0]
    acc_rows = int(lvl_rows[0])
    narrow_run = bool(lvl_cost[0] <= merge_cost)
    for t in range(1, T):
        narrow = bool(lvl_cost[t] <= merge_cost)
        if (narrow and narrow_run and mrs[t] < starts[-1]
                and acc_rows + int(lvl_rows[t]) <= merge_width):
            acc_rows += int(lvl_rows[t])
            continue
        starts.append(t)
        acc_rows = int(lvl_rows[t])
        narrow_run = narrow
    return np.asarray(starts + [T], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class CutStats:
    """Communication / balance statistics (feeds bench_comm_volume, Fig-3 analogue)."""

    boundary_rows: int
    boundary_fraction: float
    remote_tiles: int
    remote_tile_fraction: float
    level_imbalance: float  # mean over levels of max_dev_rows / mean_dev_rows
    level_cost_imbalance: float  # same, weighted by the block-row cost model


def cut_stats(bs: BlockStructure, part: Partition) -> CutStats:
    remote = part.owner[bs.off_cols] != part.owner[bs.off_rows]
    n_levels = bs.n_block_levels
    cost = block_row_cost(bs)
    # per-level, per-device row counts and cost loads
    imb, cimb = [], []
    for t in range(n_levels):
        rows_t = np.nonzero(bs.block_level == t)[0]
        if rows_t.size == 0:
            continue
        counts = np.bincount(part.owner[rows_t], minlength=part.n_devices)
        mean = counts.mean()
        if mean > 0:
            imb.append(counts.max() / mean)
        loads = np.bincount(part.owner[rows_t], weights=cost[rows_t],
                            minlength=part.n_devices)
        if loads.mean() > 0:
            cimb.append(loads.max() / loads.mean())
    return CutStats(
        boundary_rows=int(part.boundary.sum()),
        boundary_fraction=float(part.boundary.mean()),
        remote_tiles=int(remote.sum()),
        remote_tile_fraction=float(remote.mean()) if remote.size else 0.0,
        level_imbalance=float(np.mean(imb)) if imb else 1.0,
        level_cost_imbalance=float(np.mean(cimb)) if cimb else 1.0,
    )
