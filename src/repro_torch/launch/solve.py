"""SpTRSV CLI: ``python -m repro_torch.launch.solve --matrix webbase-1M [...]``.

Solves ``L x = b`` for a Table-I-suite matrix (or a synthetic one) under a
chosen scheduler and kernel backend on one device, the card unless
``--device cpu``, and prints the paper's matrix metrics, the plan's
dispatch counts, the time per solve and the relative error against scipy.
Runs through the session API (:class:`repro_torch.api.SpTRSVContext`); pass
``auto`` for ``--sched``/``--comm``/``--kernel`` to let the cost model (plus
``--probe N`` timed probe solves) pick the execution mode.

Multi-device (D devices, one process each; every ``--sched`` under
either ``--comm``, the default ``zerocopy`` included) runs under
``torch.distributed.run``::

    python -m torch.distributed.run --nproc-per-node D \
        -m repro_torch.launch.solve [--comm unified] [--sched syncfree] [...]

With ``WORLD_SIZE > 1`` in the environment every rank joins one process
group (``--dist-backend``: ``nccl`` where each rank has a card of its own,
``gloo`` for ranks sharing one card or the CPU), runs on
``cuda:{LOCAL_RANK}`` unless ``--device`` says otherwise, and solves its
device's share; rank 0 builds the CUDA kernels before the others load
them, and prints the report.

Exit status: 0; 2 when ``--verify`` finds the plan at fault; 1 when
``--tol`` is given and the relative error exceeds it.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import cut_stats, metrics
from repro_torch.core import partition as partition_strategies
from repro_torch.core.analysis import level_sets
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.sparse import suite
from repro_torch.sparse.matrix import reference_solve
from repro_torch.verify import LEVELS


def parse_args(argv: list | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--matrix", default="webbase-1M", help="Table-I name or 'random'")
    ap.add_argument("--scale", type=float, default=0.1,
                    help="Table-I size multiplier (the suite's rows x scale)")
    ap.add_argument("--n", type=int, default=2000, help="rows of --matrix random")
    ap.add_argument("--levels", type=int, default=64, help="levels of --matrix random")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:{LOCAL_RANK} under "
                         "torch.distributed.run; 'cpu' runs the plain versions)")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend when WORLD_SIZE > 1: nccl (one card "
                         "per rank) or gloo (ranks sharing a card, or the CPU)")
    ap.add_argument("--comm", default="zerocopy", choices=["zerocopy", "unified", "auto"])
    ap.add_argument("--sched", default="levelset",
                    choices=["levelset", "dagpart", "syncfree", "auto"],
                    help="'dagpart' merges runs of narrow levels into single "
                         "supersteps; tune with --merge-width/--merge-cost")
    ap.add_argument("--merge-width", type=int, default=64,
                    help="dagpart: per-device row budget of a merged superstep")
    ap.add_argument("--merge-cost", type=float, default=0.0,
                    help="dagpart: busiest-device cost below which a level "
                         "counts as narrow (0 = analytic threshold)")
    ap.add_argument("--partition", default="taskpool",
                    choices=list(partition_strategies.STRATEGIES))
    ap.add_argument("--tasks-per-device", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--kernel", default="default",
                    choices=["default", "auto"] + list(ops.BACKENDS),
                    help="executor backend: 'cuda' = the per-level switch executor "
                         "on the block kernels (the default on the card); 'fused' "
                         "= the superstep megakernel, resident or streamed by the "
                         "card's rule; 'fused_streamed' = the streamed form; "
                         "'reference' = plain PyTorch; 'auto' = cost-model / probe "
                         "selection")
    ap.add_argument("--probe", type=int, default=0,
                    help="timed probe solves per auto candidate (0 = cost model only)")
    ap.add_argument("--rhs-hint", type=int, default=1,
                    help="expected RHS panel width fed to the partition cost model")
    ap.add_argument("--calibrate-cost", action="store_true",
                    help="price malleable placement with calibrated cost weights")
    ap.add_argument("--verify", nargs="?", const="strict", default=None,
                    choices=list(LEVELS),
                    help="statically verify the plan before solving "
                         "(repro_torch.verify: happens-before + kernel-contract "
                         "lint); bare --verify means 'strict'. Exits 2 on findings.")
    ap.add_argument("--tol", type=float, default=None,
                    help="exit 1 if the relative error against scipy exceeds TOL")
    ap.add_argument("--trace", default=os.environ.get(obs_trace.ENV_TRACE),
                    metavar="PATH.jsonl",
                    help="write lifecycle spans + a final metrics snapshot "
                         f"to this JSONL file (default: env {obs_trace.ENV_TRACE})")
    ap.add_argument("--plan-store", default=None, metavar="DIR",
                    help="persistent plan store directory: reuse a previously "
                         "saved symbolic analysis for this pattern x options "
                         "(strict-verified on load) and save it when missing")
    return ap.parse_args(argv)


def join_group(args) -> tuple:
    """The process group (``None`` for one process) and this rank, from the
    environment ``torch.distributed.run`` sets; rank 0 builds the kernels
    first when the ranks run on a card."""
    import torch
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return None, 0
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if args.device is None:
        args.device = f"cuda:{local}"
    dist.init_process_group(args.dist_backend, init_method="env://")
    rank = dist.get_rank()
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(torch.device(args.device))
        if rank == 0:
            from repro_torch.kernels import extension

            extension.build()
    dist.barrier()
    return dist.group.WORLD, rank


def main(argv: list | None = None) -> int:
    args = parse_args(argv)
    group, rank = join_group(args)
    try:
        return _main(args, group, rank)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _main(args, group, rank: int) -> int:
    say = print if rank == 0 else (lambda *a, **k: None)  # the report comes from rank 0

    if args.trace:
        obs_trace.configure_tracing(args.trace)

    if args.matrix == "random":
        a = suite.random_levelled(args.n, args.levels, 4.0, seed=0)
    else:
        entry = {e.name: e for e in suite.table1_suite(args.scale)}[args.matrix]
        a = entry.build()
    m = metrics(a, level_sets(a))
    say(f"[solve] {args.matrix}: n={m.n} nnz={m.nnz} levels={m.n_levels} "
          f"dependency={m.dependency:.2f} parallelism={m.parallelism:.0f}")

    opts = PlanOptions(
        block_size=args.block_size, comm=args.comm, sched=args.sched,
        partition=args.partition, tasks_per_device=args.tasks_per_device,
        kernel=args.kernel, rhs_hint=args.rhs_hint,
        merge_width=args.merge_width, merge_cost=args.merge_cost,
        calibrate_cost=args.calibrate_cost, probe_solves=args.probe,
    )
    store = None
    if args.plan_store:
        from repro_torch.service import PlanStore

        store = PlanStore(args.plan_store)
    ctx = SpTRSVContext(device=args.device, options=opts, plan_store=store, group=group)
    handle = ctx.analyse(a)
    plan = ctx.plan(handle)
    if args.verify:
        from repro_torch.verify import verify_plan

        t0 = time.perf_counter()
        report = verify_plan(plan, level=args.verify)
        say(f"[solve] {report.summary()} in {time.perf_counter() - t0:.2f} s (host)")
        for f in report.findings:
            say(f"[solve]   {f}")
        if not report.passed:
            return 2
    cs = cut_stats(plan.bs, plan.part)
    say(f"[solve] device={ctx.device} D={ctx.n_devices} block={plan.bs.B} "
          f"block-levels={plan.n_levels} boundary={cs.boundary_fraction:.0%} "
          f"comm/solve={plan.comm_bytes_per_solve/1e3:.0f}KB "
          f"level-imbalance={cs.level_imbalance:.2f} "
          f"(cost {cs.level_cost_imbalance:.2f}) buckets={len(plan.buckets)}")
    ds = ctx.dispatch_stats(handle)
    if store is not None:
        ps = store.stats
        say(f"[solve] plan-store: hit={ds['plan_store_hit']} "
              f"(hits={ps.get('hits', 0)} misses={ps.get('misses', 0)} "
              f"rejected={ps.get('rejected', 0)} saves={ps.get('saves', 0)}) "
              f"root={store.root}")
    cfg = handle.config
    backend = ops.executor_backend(cfg.kernel_backend, ctx.device)
    if handle.auto is not None:
        sched, comm, kernel = handle.auto.chosen
        say(f"[solve] auto: sched={sched} comm={comm} kernel={kernel} "
              f"({handle.auto.mode}, probe-overhead "
              f"{handle.auto.probe_overhead_us/1e3:.1f}ms)")
    if cfg.sched in ("levelset", "dagpart"):
        stream_note = (f" copied/solve={ds['stream_dma_bytes']/1e3:.0f}KB"
                       if ds["streamed"] else "")
        merge_note = ""
        if cfg.sched == "dagpart":
            merge_note = (f" supersteps={ds['supersteps']}"
                          f"/{ds['supersteps_levelset']} "
                          f"({ds['superstep_reduction']:.1f}x fewer)")
        say(f"[solve] kernel={backend} "
              f"fused-launches={ds['fused_launches']} "
              f"switch-dispatches={ds['switch_dispatches']} "
              f"exchanges={ds['exchanges']} "
              f"streamed={ds['streamed']} "
              f"shared/CTA={ds['fused_vmem_bytes']/1e3:.1f}KB "
              f"sched-table={ds['schedule_table_bytes']/1e3:.1f}KB"
              f"{stream_note}{merge_note}")
    else:
        say(f"[solve] kernel={backend} frontier-caps={plan.frontier_caps}")

    rng = np.random.default_rng(0)
    b = rng.uniform(-1, 1, a.n)
    x = ctx.solve(handle, b)  # first solve: builds and uploads the executor
    t0 = time.perf_counter()
    for _ in range(args.repeats):
        x = ctx.solve(handle, b)
    dt = (time.perf_counter() - t0) / max(1, args.repeats)
    err = float(np.abs(x - reference_solve(a, b)).max() / np.abs(x).max())
    st = ctx.stats()
    say(f"[solve] {dt*1e3:.2f} ms/solve over {args.repeats} runs, rel.err {err:.2e} "
          f"(cache hit rate {st['cache_hit_rate']:.0%})")
    tracer = obs_trace.get_tracer()
    if tracer.enabled:
        # close the trace with one metrics line: plan-static gauges + the
        # session's runtime counters and per-solve wall-clock histogram
        snap = ctx.metrics_snapshot(handle)
        tracer.write({"type": "metrics", "metrics": snap})
        names = sorted({r["name"] for r in tracer.export() if r.get("type") == "span"})
        say(f"[solve] trace: {len(tracer.export())} records -> {tracer.path} "
              f"(spans: {', '.join(names)})")
        tracer.close()
    if args.tol is not None and not err <= args.tol:
        say(f"[solve] FAIL: rel.err {err:.2e} > --tol {args.tol}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
