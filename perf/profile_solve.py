#!/usr/bin/env python3
"""Where one triangular solve's time goes on the card.

    python3 perf/profile_solve.py [--side 1024] [--block-size 32] [--rhs 1]
                                  [--backend cuda|fused|fused_streamed]
                                  [--sched levelset|syncfree]

Builds the ``chip_smoke.py`` main-path problem (``grid2d_factor(side,
seed=6)``, B = 32; phase 14's is ``--side 512 --block-size 176`` or 256,
where the streamed form copies row chunks) for the switch executor (``cuda``, the default) or the
superstep megakernel (``fused``, or its streamed form ``fused_streamed``);
with ``--sched syncfree``, for the syncfree executor's dense scan
(``cuda``) or its frontier-bucketed form (``fused``, ``fused_streamed``),
and prints its sweeps and host reads per solve. It warms the executor, then
traces one forward solve with ``torch.profiler`` and prints: the solve's
wall time (untraced, the median of 5 solves; and traced), the summed
device time of its kernels, the device's idle share of the traced wall
time, and the operations ranked by host and by device time.
For the megakernel it then splits its time with CUDA events, per launch
and per level: the whole launch; one without tile products (every update
width 0: no row pulls, so no row waits for another, and the streamed form
copies only the diagonal tiles); and one without solves either (every solve
slot a pad as well: the launch and the walk over the levels alone, which
copies every row's carry through and sets no flag, and no pull waits for
one). The syncfree executor has no megakernel, so no split. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--side", type=int, default=1024)
    parser.add_argument("--block-size", type=int, default=32)
    parser.add_argument("--rhs", type=int, default=1, help="RHS panel width (1 = vector)")
    parser.add_argument("--backend", choices=("cuda", "fused", "fused_streamed"),
                        default="cuda")
    parser.add_argument("--sched", choices=("levelset", "syncfree"), default="levelset")
    args = parser.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import PlanOptions, SpTRSVContext
    from repro_torch.core.blocking import pad_rhs
    from repro_torch.sparse import suite

    if not torch.cuda.is_available():
        sys.exit("profile_solve.py needs a CUDA device")
    a = suite.grid2d_factor(args.side, seed=6)
    ctx = SpTRSVContext(options=PlanOptions(block_size=args.block_size, kernel=args.backend,
                                            sched=args.sched))
    solver = ctx.executor(ctx.analyse(a))
    shape = (a.n,) if args.rhs == 1 else (a.n, args.rhs)
    b = np.random.default_rng(0).uniform(-1, 1, shape)
    b_blocks = torch.from_numpy(pad_rhs(b, solver.plan.bs)).cuda()
    for _ in range(2):
        solver.solve_blocks(b_blocks)
    torch.cuda.synchronize()

    untraced = []
    for _ in range(5):
        t0 = time.perf_counter()
        solver.solve_blocks(b_blocks)
        torch.cuda.synchronize()
        untraced.append(1e3 * (time.perf_counter() - t0))
    untraced_ms = sorted(untraced)[2]

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve_blocks(b_blocks)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # kernel rows only: the aten rows repeat their kernels' device time
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"[profile] {torch.cuda.get_device_name(0)} ({card_line()}); n={a.n} "
          f"levels={solver.plan.n_levels} B={args.block_size} "
          f"R={args.rhs} backend={args.backend} sched={args.sched}")
    print(f"[profile] solve wall: untraced {untraced_ms:.2f} ms (median of 5; "
          f"{', '.join(f'{t:.2f}' for t in untraced)}), traced {traced_ms:.2f} ms; "
          f"device kernel time {device_us / 1e3:.3f} ms; device idle share "
          f"{1 - device_us / 1e3 / traced_ms:.4f} of the traced wall")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=14,
                                    max_name_column_width=48))
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=10,
                                    max_name_column_width=48))
    if args.sched == "syncfree":
        print(f"[profile] syncfree {'frontier' if solver._syncfree.frontier else 'dense'} "
              f"form: {solver._syncfree.sweeps} sweeps, {solver._syncfree.host_reads} "
              f"host reads per solve")
    elif args.backend != "cuda":
        split = megakernel_split(solver, b_blocks)
        levels = max(1, solver.plan.n_levels)
        print(f"[profile] megakernel split over {solver.plan.n_levels} levels, ms per launch "
              f"(µs per level): " + "; ".join(f"{k} {v:.3f} ({1e3 * v / levels:.3f})"
                                             for k, v in split.items()))


def card_line() -> str:
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def megakernel_split(solver, b_blocks) -> dict:
    """ms per launch of the whole megakernel launch and of two stripped
    launches over the same levels (CUDA events, mean of 10 after a warm
    call): ``whole``, ``without tile products``, ``without solves (launch
    and level walk)``. ``chip_smoke.py`` phase 14 logs it too."""
    import numpy as np
    import torch

    from repro_torch.core.solver import level_widths
    from repro_torch.kernels import superstep

    plan, fused = solver.plan, solver._fused
    b_pad = torch.cat([b_blocks, b_blocks.new_zeros((1,) + b_blocks.shape[1:])])
    zeros = torch.zeros_like(b_pad)

    def dev(t):
        return torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32)).cuda()

    def timed(tables, stp):
        host = [t.cpu().numpy() for t in tables]
        ready = superstep.ReadyFlags(plan.bs.nb + 1, "cuda")  # kept from launch to launch
        if fused.layout is not None:  # the streamed form: its own store for these tables
            layout = superstep.streamed_layout(*host, n_rows=plan.bs.nb + 1,
                                               stp=stp.cpu().numpy()).to("cuda")
            values = superstep.streamed_values(  # the solver keeps only its own store
                layout, torch.from_numpy(plan.diag).cuda(),
                torch.from_numpy(np.ascontiguousarray(plan.tiles[0])).cuda())

            def run():
                superstep.superstep_streamed_call(*tables, values, b_pad, zeros, zeros,
                                                  stp=stp, layout=layout, flags=ready)
        else:
            table = superstep.superstep_table(*host, n_rows=plan.bs.nb + 1,
                                              stp=stp.cpu().numpy()).to("cuda")

            def run():
                superstep.superstep_call(*tables, solver._diag, solver._tiles, b_pad, zeros,
                                         zeros, stp=stp, table=table, flags=ready)

        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 10

    seg, off, wid, sr, ut, trow, tcol = fused.tables
    no_updates = level_widths(plan).copy()
    no_updates[:, 1] = 0
    pads = np.full_like(plan.solve_rows[0], -1)
    split = {"whole": timed(fused.tables, fused.stp),
             "without tile products": timed([seg, off, dev(no_updates), sr, ut, trow, tcol],
                                            fused.stp),
             "without solves (launch and level walk)": timed(
                 [seg, off, dev(no_updates), dev(pads), ut, trow, tcol], fused.stp)}
    return split


if __name__ == "__main__":
    main()
