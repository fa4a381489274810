"""Backend auto-tuning for the session API.

The right execution mode is matrix-dependent: a chain-skewed factor wants the
fused megakernel's single launch (and ``dagpart``'s merged supersteps), a
wide shallow DAG may want the syncfree frontier. ``PlanOptions`` marks any of
``sched``/``comm``/``kernel`` as ``"auto"`` and this module resolves them:

1. enumerate the candidate (sched, comm, kernel) combinations — all sharing
   ONE partition, so auto-tuning never re-analyses the pattern;
2. score each candidate plan with the calibrated block-op cost model
   (:func:`repro_torch.core.costmodel.calibrate_weights` x the plan's
   bucketized schedule widths, plus comm-byte, bulk-copy and dispatch
   terms);
3. optionally (``probe_solves > 0``) build each candidate's executor and
   time real probe solves on the device at the expected RHS width, choosing
   the measured minimum; each probe records one calibration sample
   (:mod:`repro_torch.obs.calibration`).

The decision — chosen combination, per-candidate scores/timings, probe
overhead — is recorded as an :class:`AutoDecision` and surfaced through
``SpTRSVContext.dispatch_stats``.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.costmodel import FLOPS_PER_BYTE, calibrate_weights
from repro_torch.core.solver import (
    Plan,
    Solver,
    dispatch_stats,
    fused_streaming,
    level_widths,
    stream_dma_bytes_per_solve,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.obs import calibration as _calibration
from repro_torch.obs.trace import get_tracer

# One executor dispatch (a launch or a collective) costs about this many
# block-op units in the model: the reference model's knob, in model units,
# that lets launch-bound schedules (many tiny levels) prefer the fused path.
DISPATCH_OVERHEAD = 8.0

# On the CPU the fused levelset backends run the megakernel's plain version
# (a Python loop over levels and rows): never the fast choice there, and the
# model must know what probes would measure.
INTERPRET_PENALTY = 100.0

SCHED_CANDIDATES = ("levelset", "dagpart", "syncfree")
COMM_CANDIDATES = ("zerocopy", "unified")


def kernel_candidates(device) -> tuple:
    """The device's default executor backend plus the two megakernel forms
    (resident and streamed store)."""
    return (ops.executor_backend(None, device), "fused", "fused_streamed")


@dataclasses.dataclass(frozen=True)
class AutoDecision:
    """Record of one auto-tuning pass (kept on the analysis handle)."""

    chosen: tuple  # (sched, comm, kernel)
    mode: str  # "probed" | "modelled"
    scores: dict  # (sched, comm, kernel) -> model score, block-op units
    probe_us: dict  # (sched, comm, kernel) -> measured us/solve ({} unless probed)
    probe_overhead_us: float  # wall time spent probing (build + measure)
    # (sched, comm, kernel) -> wall time of building the candidate's executor
    # and its first solve, kept OUT of probe_us so the measured ranking never
    # depends on which candidate built last ({} unless probed)
    compile_us: dict = dataclasses.field(default_factory=dict)

    def as_derived(self) -> str:
        """Compact ``k=v;...`` form for bench rows / dispatch_stats."""
        sched, comm, kernel = self.chosen
        return (f"sched={sched};comm={comm};kernel={kernel};mode={self.mode};"
                f"probe_overhead_us={self.probe_overhead_us:.0f}")


def plan_work_units(plan: Plan, R: int = 1) -> tuple[float, float, float]:
    """``(su, tu, tf)`` schedule work units for one solve at RHS width R:
    the regressors of the compute term ``w_solve*su + w_tile_mem*tu +
    w_tile_flop*tf``. Shared by :func:`estimate_plan_cost` and the
    calibration recorder so fitted weights mean exactly what the scorer
    multiplies them by."""
    cfg = plan.config
    wid = level_widths(plan) if plan.n_levels else np.zeros((0, 3), np.int64)
    fused = cfg.kernel_backend in ops.FUSED_BACKENDS  # None is never fused
    if cfg.sched != "syncfree" or fused:
        # frontier-bucketed syncfree work is approximated by the same
        # per-level schedule widths the levelset executors dispatch
        n_solve, n_tiles = float(wid[:, 0].sum()), float(wid[:, 1].sum())
    else:
        # dense scan: every sweep touches all local rows and tiles
        sweeps = plan.n_supersteps
        n_solve = float(sweeps * plan.local_rows.shape[1])
        n_tiles = float(sweeps * plan.tiles.shape[1])
    return n_solve * R, n_tiles, n_tiles * R


def estimate_plan_cost(plan: Plan, R: int = 1, device=None) -> float:
    """Model one solve of ``plan`` on ``device`` (``None``: the card) in
    calibrated block-op units.

    Compute term: the bucketized per-level schedule widths weighted by
    :func:`calibrate_weights` for the plan's backend on the device.
    Comm term: ``comm_bytes_per_solve`` at the model's byte balance, in
    units of one B²-flop block op. Bulk-copy term: the bytes the streamed
    megakernel copies (the port's kernel copies once per column; at ``B >=
    170`` in row chunks, the same bytes). Overhead
    term: dispatch/launch counts from :func:`dispatch_stats` (levelset) or
    two dispatches per sweep (syncfree)."""
    dev = resolve_device(device)
    cfg = plan.config
    B = plan.bs.B
    w_solve, w_tile_mem, w_tile_flop = calibrate_weights(B, cfg.kernel_backend, device=dev)
    fused = ops.executor_backend(cfg.kernel_backend, dev) in ops.FUSED_BACKENDS
    su, tu, tf = plan_work_units(plan, R)
    compute = w_solve * su + w_tile_mem * tu + w_tile_flop * tf
    if cfg.sched != "syncfree":
        ds = dispatch_stats(plan)
        launches = (ds["fused_launches"] if fused
                    else ds["switch_dispatches"]) + ds["exchanges"]
    else:
        launches = 2 * plan.n_supersteps  # one solve + one update dispatch per sweep
    comm = plan.comm_bytes_per_solve * FLOPS_PER_BYTE / (B * B)
    # fused_streaming also covers plain "fused" above the stream limit, so
    # the model prices what would actually execute
    dma = 0.0
    if fused and fused_streaming(plan, R):
        dma = stream_dma_bytes_per_solve(plan, R) * FLOPS_PER_BYTE / (B * B)
    cost = compute + comm + dma + DISPATCH_OVERHEAD * launches
    if fused and cfg.sched != "syncfree" and dev.type == "cpu":
        cost *= INTERPRET_PENALTY
    return cost


def candidate_grid(options, n_devices: int | None = None, device=None) -> list:
    """All concrete (sched, comm, kernel) combos for ``options``' auto dims.

    On one device comm is vacuous (no collectives execute), so an auto comm
    axis collapses to zerocopy instead of probing the same program twice.
    """
    from repro_torch.api.options import Comm, KernelBackend, Sched

    scheds = SCHED_CANDIDATES if options.sched == Sched.AUTO else (options.sched.value,)
    comms = COMM_CANDIDATES if options.comm == Comm.AUTO else (options.comm.value,)
    if n_devices == 1 and options.comm == Comm.AUTO:
        comms = ("zerocopy",)
    kernels = (kernel_candidates(resolve_device(device))
               if options.kernel == KernelBackend.AUTO else (options.kernel.value,))
    return list(itertools.product(scheds, comms, kernels))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tune(a, options, device=None, *, part=None, bs=None, group=None):
    """Resolve ``options``' auto dimensions for matrix ``a`` on one device
    (``None``: the card), or on every rank of ``group`` (a
    ``torch.distributed`` group, one rank per device: the candidates are
    ``D``-device plans, ``D`` the group's size).

    Returns ``(config, plan, decision, solver)`` — the winning concrete
    :class:`SolverConfig`, its plan (built on the shared partition), the
    :class:`AutoDecision`, and, when probing built the winner anyway, its
    ready-to-use :class:`Solver` (else ``None``).

    Probes run on the device: the right-hand side is uploaded once; each
    candidate's executor is built and solves once untimed (building and
    uploading, and on the card the first launch: ``compile_us``), once more
    as a warm-up, then ``probe_solves`` times, each between two
    synchronizations; ``probe_us`` is the median.

    Every rank of a group reaches the same decision: rank 0's candidate
    list and modelled scores are broadcast (weights measured on the card
    may differ between ranks), and after the probes each candidate's
    median and build time are the group's largest (the group's solve takes
    as long as its slowest rank), one ``all_reduce``. Each rank records
    those group times into its calibration store, so the stores stay
    alike; only rank 0's writes its file.
    """
    from repro_torch.core.blocking import build_blocks, pad_rhs
    from repro_torch.core.partition import make_partition
    from repro_torch.core.solver import build_plan

    dev = resolve_device(device)
    D = 1 if group is None else comm.size(group)
    rank = 0 if group is None else comm.rank(group)
    if bs is None:
        bs = build_blocks(a, options.block_size)
    if part is None:
        part = make_partition(bs, D, options.partition.value,
                              options.tasks_per_device, cost_R=options.rhs_hint)
    combos = candidate_grid(options, D, dev)

    plans, scores = {}, {}
    with get_tracer().span("sptrsv.autotune", n_candidates=len(combos),
                           probe_solves=options.probe_solves) as tspan:
        for combo in combos:
            sched, comm_mode, kernel = combo
            if kernel == "fused_streamed" and (sched, comm_mode, "fused") in plans:
                # never probe the same executor twice: syncfree runs both fused
                # backends as the same frontier form, and plain "fused" above
                # the stream limit already runs the streamed megakernel
                if sched == "syncfree" or fused_streaming(
                        plans[(sched, comm_mode, "fused")], options.rhs_hint):
                    continue
            cfg = options.to_config(sched=sched, comm=comm_mode, kernel=kernel)
            plans[combo] = build_plan(a, D, cfg, part=part, device=dev)
            scores[combo] = estimate_plan_cost(plans[combo], R=options.rhs_hint, device=dev)
        if group is not None:
            # one candidate list and one set of scores on every rank: rank 0's
            combos, scores = comm.broadcast_object(
                ([c for c in combos if c in plans], scores), group)
            for combo in combos:
                if combo not in plans:
                    plans[combo] = build_plan(a, D, options.to_config(
                        sched=combo[0], comm=combo[1], kernel=combo[2]), part=part,
                        device=dev)
        combos = [c for c in combos if c in plans]

        probe_us: dict = {}
        compile_us: dict = {}
        solvers: dict = {}
        t_probe0 = time.perf_counter()
        if options.probe_solves > 0 and len(combos) > 1:
            rng = np.random.default_rng(0)
            R = options.rhs_hint
            b = rng.uniform(-1, 1, (a.n, R) if R > 1 else a.n).astype(np.float32)
            b_blocks = torch.from_numpy(pad_rhs(b, bs)).to(dev)
            store = _calibration.get_store()
            for combo in combos:
                with get_tracer().span("sptrsv.probe", sched=combo[0],
                                       comm=combo[1], kernel=combo[2]) as sp:
                    _sync(dev)
                    t_c = time.perf_counter()
                    solver = solvers[combo] = Solver(plans[combo], dev, group)
                    solver.solve_blocks(b_blocks)
                    _sync(dev)
                    compile_us[combo] = (time.perf_counter() - t_c) * 1e6
                    solver.solve_blocks(b_blocks)  # warm-up
                    times = []
                    for _ in range(options.probe_solves):
                        _sync(dev)
                        t0 = time.perf_counter()
                        solver.solve_blocks(b_blocks)
                        _sync(dev)
                        times.append(time.perf_counter() - t0)
                    times.sort()
                    probe_us[combo] = times[len(times) // 2] * 1e6
                    sp.set(probe_us=probe_us[combo], compile_us=compile_us[combo])
            if group is not None:  # the group's times: its slowest rank's
                worst = comm.group_max([[probe_us[c], compile_us[c]] for c in combos],
                                       group, dev)
                probe_us = {c: float(w[0]) for c, w in zip(combos, worst)}
                compile_us = {c: float(w[1]) for c, w in zip(combos, worst)}
            for combo in combos:
                # the measured solve is a sample of the cost model's compute
                # term: keep it for probe-free sessions
                su, tu, tf = plan_work_units(plans[combo], R)
                store.record(
                    backend=ops.executor_backend(combo[2], dev), B=plans[combo].bs.B,
                    device=dev, signature=_calibration.probe_signature(plans[combo], R, dev),
                    solve_units=su, tile_units=tu, tile_flop_units=tf, R=R,
                    measured_us=probe_us[combo], persist=rank == 0,
                )
            chosen = min(combos, key=lambda c: probe_us[c])
            mode = "probed"
        else:
            chosen = min(combos, key=lambda c: scores[c])
            mode = "modelled"
        overhead = (time.perf_counter() - t_probe0) * 1e6 if probe_us else 0.0
        decision = AutoDecision(chosen=chosen, mode=mode, scores=scores,
                                probe_us=probe_us, probe_overhead_us=overhead,
                                compile_us=compile_us)
        tspan.set(chosen="/".join(chosen), mode=mode,
                  probe_overhead_us=overhead)
    cfg = options.to_config(sched=chosen[0], comm=chosen[1], kernel=chosen[2])
    return cfg, plans[chosen], decision, solvers.get(chosen)
