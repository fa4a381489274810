"""SpTRSV serving CLI: ``python -m repro_torch.launch.serve_solve [...]``.

Stands up an in-process :class:`repro_torch.service.SolveEngine` on one
device (the card unless ``--device cpu``) and feeds it a multi-tenant
hot/cold request mix: ``--patterns`` distinct sparsity patterns, with
``--hot-fraction`` of all requests landing on pattern 0 (the "hot"
preconditioner every iterative solver hammers) and the rest spread over the
cold tail. Pattern 0 is ``grid2d_factor(--hot-side)`` when that is given,
else a synthetic levelled pattern of ``--n`` rows. Prints the serving
numbers — solves/s at the mix, coalesce width, plan-store hit rate — rather
than single-solve latency, and the largest relative error of the served
solutions against scipy.

``--dyadic`` gives every pattern unit-diagonal, +-2^-k values and every
request the right-hand side ``b = L x`` of a small-integer ``x``: every
partial sum of the solve is then exact in float32, so any correct order of
the work gives ``x`` bit for bit, and each ticket is checked for exactly
that.

Multi-device (D devices, one process each) runs under
``torch.distributed.run``, as ``launch/solve.py`` does::

    python -m torch.distributed.run --nproc-per-node D \
        -m repro_torch.launch.serve_solve [--dist-backend gloo] [...]

Rank 0 builds the mix, takes the requests and prints the report; every
other rank follows its batches (:meth:`repro_torch.service.SolveEngine.follow`).

``--solo-check`` serves every request once more alone (a batch of one) and
requires each ticket of the mix to equal its solo solve bit for bit.

Run it twice against the same ``--plan-store`` directory: the first (cold)
run pays one symbolic analysis per pattern and saves the plans; the second
(warm) run serves the same mix with **zero** symbolic analyses, which
``--assert-warm`` turns into the exit status.

Exit status: 0; 2 when an ``--assert-*`` check fails; 1 when a served
solution is wrong (``--tol`` against scipy, or not exact under
``--dyadic``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from repro_torch.api import PlanOptions
from repro_torch.kernels import ops
from repro_torch.obs import trace as obs_trace
from repro_torch.service import SolveEngine
from repro_torch.sparse import suite
from repro_torch.sparse.matrix import CSR, reference_solve, to_scipy


def dyadic(a: CSR, seed: int = 0) -> CSR:
    """Same sparsity, unit diagonal, +-2^-k off-diagonals: with ``b = L x``
    for a small-integer ``x``, every partial sum of the solve is exact in
    float32."""
    rows = np.repeat(np.arange(a.n), np.diff(a.row_ptr))
    signs = np.random.default_rng(seed).choice(
        np.array([-0.5, -0.25, 0.25, 0.5], np.float32), size=a.val.shape)
    return CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
               val=np.where(a.col_idx == rows, 1.0, signs).astype(np.float32))


def build_patterns(n_patterns: int, n: int, levels: int, seed: int,
                   hot_side: int = 0) -> list:
    """Distinct lower-triangular patterns, sized down the tail so the cold
    patterns are cheap and the hot one dominates the work."""
    mats = []
    for p in range(n_patterns):
        if p == 0 and hot_side:
            mats.append(suite.grid2d_factor(hot_side, seed=6))
            continue
        np_ = max(64, n // (1 + p))
        mats.append(suite.random_levelled(np_, max(4, levels // (1 + p)), 4.0,
                                          seed=seed + p))
    return mats


def request_mix(n_requests: int, n_patterns: int, hot_fraction: float,
                seed: int) -> list[int]:
    """Pattern index per request: ``hot_fraction`` on pattern 0, the rest
    uniform over the cold tail, in a shuffled arrival order."""
    rng = np.random.default_rng(seed)
    n_hot = int(round(n_requests * hot_fraction))
    mix = [0] * n_hot
    if n_patterns > 1:
        mix += [1 + int(rng.integers(n_patterns - 1))
                for _ in range(n_requests - n_hot)]
    else:
        mix += [0] * (n_requests - n_hot)
    rng.shuffle(mix)
    return mix


def parse_args(argv: list | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve_solve")
    ap.add_argument("--patterns", type=int, default=3,
                    help="distinct sparsity patterns in the mix")
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--hot-fraction", type=float, default=0.7,
                    help="fraction of requests on pattern 0")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--n", type=int, default=512,
                    help="rows of the hot pattern (the tail scales from it)")
    ap.add_argument("--hot-side", type=int, default=0,
                    help="make the hot pattern grid2d_factor(SIDE) (n = SIDE^2)")
    ap.add_argument("--levels", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:{LOCAL_RANK} under "
                         "torch.distributed.run; 'cpu' runs the plain versions)")
    ap.add_argument("--dist-backend", default="nccl", choices=["nccl", "gloo"],
                    help="process-group backend when WORLD_SIZE > 1: nccl (one card "
                         "per rank) or gloo (ranks sharing a card, or the CPU)")
    ap.add_argument("--solo-check", action="store_true",
                    help="serve each request again alone; every ticket of the mix "
                         "must equal its solo solve bit for bit")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="coalesced RHS columns per served panel")
    ap.add_argument("--max-wait-ms", type=float, default=0.0,
                    help="admission window before a partial batch dispatches")
    ap.add_argument("--cache-capacity", type=int, default=None,
                    help="LRU bound on the session's executor cache")
    ap.add_argument("--block-size", type=int, default=32)
    ap.add_argument("--sched", default="levelset",
                    choices=["levelset", "dagpart", "syncfree", "auto"])
    ap.add_argument("--comm", default="zerocopy", choices=["zerocopy", "unified", "auto"])
    ap.add_argument("--kernel", default="default",
                    choices=["default", "auto"] + list(ops.BACKENDS))
    ap.add_argument("--dyadic", action="store_true",
                    help="exact problems: dyadic values, b = L x for integer x; "
                         "every served x must equal that x bit for bit")
    ap.add_argument("--tol", type=float, default=1e-4,
                    help="largest relative error against scipy a served solution may have")
    ap.add_argument("--plan-store", default=None, metavar="DIR",
                    help="persistent plan store (a cold run populates it; a "
                         "warm run serves with zero symbolic analyses)")
    ap.add_argument("--assert-warm", action="store_true",
                    help="exit 2 unless the mix was served with ZERO symbolic "
                         "analyses (needs a populated --plan-store)")
    ap.add_argument("--assert-hit-rate", type=float, default=None,
                    metavar="MIN", help="exit 2 if the plan-store hit rate "
                    "falls below MIN")
    ap.add_argument("--trace", default=os.environ.get(obs_trace.ENV_TRACE),
                    metavar="PATH.jsonl")
    args = ap.parse_args(argv)
    if args.hot_side:
        args.n = args.hot_side * args.hot_side
    return args


@dataclasses.dataclass
class Served:
    """What one run of the mix left behind."""

    engine: SolveEngine
    mats: list
    tickets: list
    answers: list  # per ticket, the exact x under --dyadic, else None
    wall_s: float
    max_rel_err: float
    exit_code: int


def _engine(args: argparse.Namespace, group) -> SolveEngine:
    opts = PlanOptions(block_size=args.block_size, sched=args.sched,
                       comm=args.comm, kernel=args.kernel)
    return SolveEngine(device=args.device, options=opts,
                       plan_store=args.plan_store, max_batch=args.max_batch,
                       max_wait_s=args.max_wait_ms / 1e3,
                       cache_capacity=args.cache_capacity, group=group)


def serve(args: argparse.Namespace, group=None) -> Served:
    """Serve the mix ``args`` describe; print the serving numbers. With a
    ``group`` this is rank 0, and the other ranks run :func:`follow`."""
    if args.trace:
        obs_trace.configure_tracing(args.trace)
    mats = build_patterns(args.patterns, args.n, args.levels, args.seed, args.hot_side)
    if args.dyadic:
        mats = [dyadic(m, seed=args.seed + p) for p, m in enumerate(mats)]
    mix = request_mix(args.requests, args.patterns, args.hot_fraction, args.seed)
    rng = np.random.default_rng(args.seed + 1)
    rhs, answers = [], []
    for p in mix:
        if args.dyadic:
            x = rng.integers(-4, 5, mats[p].n).astype(np.float64)
            rhs.append((to_scipy(mats[p]) @ x).astype(np.float32))
            answers.append(x.astype(np.float32))
        else:
            rhs.append(rng.uniform(-1, 1, mats[p].n).astype(np.float32))
            answers.append(None)

    engine = _engine(args, group)
    print(f"[serve] device={engine.device} D={engine.ctx.n_devices} "
          f"patterns={[m.n for m in mats]} "
          f"requests={args.requests} hot={args.hot_fraction:.0%} "
          f"tenants={args.tenants} max_batch={args.max_batch} "
          f"kernel={args.kernel} dyadic={args.dyadic} "
          f"plan_store={args.plan_store or '-'}")
    t0 = time.perf_counter()
    tickets = [engine.submit(f"tenant{i % args.tenants}", mats[p], b)
               for i, (p, b) in enumerate(zip(mix, rhs))]
    served = engine.drain()
    wall_s = time.perf_counter() - t0
    st = engine.stats()  # the mix's counters, before any solo solve

    exit_code, worst = 0, 0.0
    for t, want in zip(tickets, answers):
        x = t.result(timeout=0)
        if want is not None and not np.array_equal(x, want):
            print(f"[serve] FAIL: request {t.request.id} is not the exact solution")
            exit_code = 1
        if args.solo_check:
            solo = engine.submit("solo", t.request.matrix, t.request.rhs)
            engine.drain()
            if not np.array_equal(x, solo.result(timeout=0)):
                print(f"[serve] FAIL: request {t.request.id} differs from its solo solve")
                exit_code = 1
        ref = reference_solve(t.request.matrix, t.request.rhs)
        worst = max(worst, float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30)))
    if not worst <= args.tol:
        print(f"[serve] FAIL: rel.err {worst:.2e} against scipy > --tol {args.tol}")
        exit_code = 1

    engine.close()
    sess, ps = st["session"], st.get("plan_store", {})
    width = st["coalesced_columns"] / st["batches"] if st["batches"] else 0.0
    lat = sorted(t.latency_s for t in tickets)
    p50, p99 = lat[len(lat) // 2], lat[min(len(lat) - 1, int(len(lat) * .99))]
    print(f"[serve] served {served}/{args.requests} in {wall_s*1e3:.0f}ms: "
          f"{served / wall_s:.0f} req/s via {st['batches']} batches "
          f"({st['solves'] / wall_s:.1f} solves/s, coalesce width {width:.2f}, "
          f"pad {st['pad_columns']} cols); max rel.err vs scipy {worst:.2e}")
    print(f"[serve] latency p50={p50*1e3:.1f}ms p99={p99*1e3:.1f}ms | "
          f"analyses={sess.get('analyses', 0)} "
          f"plan_store_hits={sess.get('plan_store_hits', 0)} "
          f"store hit_rate={ps.get('hit_rate', 0.0):.0%} "
          f"rejected={ps.get('rejected', 0)} "
          f"evictions={sess.get('evictions', 0)}")

    tracer = obs_trace.get_tracer()
    if tracer.enabled:
        tracer.write({"type": "metrics", "metrics": engine.registry.snapshot()})
        names = sorted({r["name"] for r in tracer.export() if r.get("type") == "span"})
        print(f"[serve] trace: {len(tracer.export())} records -> "
              f"{tracer.path} (spans: {', '.join(names)})")
        tracer.close()

    if args.assert_warm and sess.get("analyses", 0) != 0:
        print(f"[serve] FAIL: --assert-warm but {sess['analyses']} symbolic analyses ran")
        exit_code = exit_code or 2
    if (args.assert_hit_rate is not None
            and ps.get("hit_rate", 0.0) < args.assert_hit_rate):
        print(f"[serve] FAIL: plan-store hit rate {ps.get('hit_rate', 0.0):.2f} "
              f"< --assert-hit-rate {args.assert_hit_rate}")
        exit_code = exit_code or 2
    return Served(engine=engine, mats=mats, tickets=tickets, answers=answers,
                  wall_s=wall_s, max_rel_err=worst, exit_code=exit_code)


def follow(args: argparse.Namespace, group) -> int:
    """A rank other than 0: serve rank 0's batches until it closes."""
    engine = _engine(args, group)
    engine.follow()
    return 0


def main(argv: list | None = None) -> int:
    from repro_torch.launch.solve import join_group

    args = parse_args(argv)
    group, rank = join_group(args)
    try:
        return serve(args, group).exit_code if rank == 0 else follow(args, group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
