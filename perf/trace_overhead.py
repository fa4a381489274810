#!/usr/bin/env python3
"""What the executor's trace ranges cost: the switch forward solve with
tracing off and on, and against another checkout with tracing off.

    python3 perf/trace_overhead.py [--pairs 10] [--side 1024] [--parent DIR]

Solves ``grid2d_factor(side, seed=6)`` (B = 32, levelset, the switch
executor on the card's block kernels) through ``SpTRSVContext.solve``
(numpy out, so each time covers the device's work) after one warm solve.
In this tree: ``--pairs`` alternating pairs, tracing off then on
(``obs.trace.trace_to``; the executor then opens two ``record_function``
ranges per level). With ``--parent DIR`` (a checkout, e.g. ``git archive``
of the parent commit unpacked into ``build/parent``): child processes run
the parent's tree and this one in turns parent, change, change, parent,
each timing ``--pairs`` untraced solves; the parent tree needs no
telemetry. Prints the card line, then per run the median, quartiles, min
and max ms. Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _quartiles(ms: list) -> dict:
    import numpy as np

    q1, med, q3 = (float(v) for v in np.percentile(ms, [25, 50, 75]))
    return {"median": med, "q1": q1, "q3": q3, "min": min(ms), "max": max(ms), "n": len(ms)}


def _solve_ms(src: Path, side: int, pairs: int, traced: bool) -> dict:
    """Time forward solves with the package under ``src``; with ``traced``
    alternate untraced and traced solves."""
    sys.path.insert(0, str(src))
    import time

    import numpy as np
    import torch

    from repro_torch.api import SpTRSVContext
    from repro_torch.sparse import suite

    a = suite.grid2d_factor(side, seed=6)
    ctx = SpTRSVContext()
    h = ctx.analyse(a)
    b = np.random.default_rng(0).uniform(-1, 1, a.n)
    ctx.solve(h, b)  # builds the plan and the executor, first launches
    torch.cuda.synchronize()
    if traced:
        from repro_torch.obs import trace
    times = {"off": [], "on": []}
    for _ in range(pairs):
        for mode in (("off", "on") if traced else ("off",)):
            with trace.trace_to() if mode == "on" else contextlib.nullcontext():
                t0 = time.perf_counter()
                ctx.solve(h, b)
                times[mode].append(1e3 * (time.perf_counter() - t0))
    return {mode: _quartiles(v) for mode, v in times.items() if v}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--side", type=int, default=1024)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--child", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:  # one timed run in its own process
        print(json.dumps(_solve_ms(args.child, args.side, args.pairs, traced=False)))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_overhead.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    if args.parent is None:
        res = _solve_ms(ROOT / "src", args.side, args.pairs, traced=True)
        print(f"tracing off/on, {args.pairs} alternating pairs: {json.dumps(res)}; "
              f"median on/off {res['on']['median'] / res['off']['median']:.4f}")
        return
    parent = args.parent.resolve()
    for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              str(tree / "src"), "--pairs", str(args.pairs),
                              "--side", str(args.side)],
                             capture_output=True, text=True, check=True)
        print(f"{name} ({tree}) untraced forward ms: {out.stdout.strip().splitlines()[-1]}",
              flush=True)


if __name__ == "__main__":
    main()
