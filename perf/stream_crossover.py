#!/usr/bin/env python3
"""Resident against streamed megakernel, ms per solve, by plan size, on the card.

    python3 perf/stream_crossover.py [--sides 32 64 128 256] [--blocks 16 32]
                                     [--solves 20]

For each block size B and side, builds ``grid2d_factor(side, seed=6)``'s
plan twice on one card: ``kernel_backend="fused"`` held resident
(``REPRO_TORCH_STREAM_LIMIT`` above its store while the executor is built)
and ``"fused_streamed"``. Checks the two forward solves bit-equal, then
times ``Solver.solve_blocks`` (one megakernel launch and its few tensor ops)
by CUDA events over ``--solves`` solves queued back to back
(:func:`repro_torch.obs.timing.device_time_ms`), in turns resident,
streamed, streamed, resident. Prints the card line, one row per (B, side):
the resident store bytes (``diag`` + ``tiles``), both ms (the mean of each
form's two turns), the ratio streamed / resident, and the four turns; then
:func:`crossover_bytes` of the table, the store size from which streaming
is no slower at every larger size measured (the rule behind
``core.solver.DEFAULT_STREAM_LIMIT``). ``chip_smoke.py`` phase 9 runs
:func:`measure` at the default sides and blocks, phase 14 at B = 64, 128,
176 and 256 (from B = 170 the streamed kernel copies row chunks). Needs a
CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIDES = (32, 64, 128, 256)
BLOCKS = (16, 32)
SOLVES = 20
ENV_LIMIT = "REPRO_TORCH_STREAM_LIMIT"


@contextlib.contextmanager
def stream_limit_env(value: int):
    """Set ``REPRO_TORCH_STREAM_LIMIT`` for the block, restoring it after."""
    old = os.environ.get(ENV_LIMIT)
    os.environ[ENV_LIMIT] = str(int(value))
    try:
        yield
    finally:
        if old is None:
            del os.environ[ENV_LIMIT]
        else:
            os.environ[ENV_LIMIT] = old


def measure(sides=SIDES, blocks=BLOCKS, solves: int = SOLVES, seed: int = 0) -> list:
    """One row per (B, side), as the module docstring says."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    from repro_torch.core.blocking import pad_rhs
    from repro_torch.core.solver import Solver, SolverConfig, build_plan
    from repro_torch.obs.timing import device_time_ms
    from repro_torch.sparse import suite

    rng = np.random.default_rng(seed)
    rows = []
    for B in blocks:
        for side in sides:
            a = suite.grid2d_factor(side, seed=6)
            plan = build_plan(a, 1, SolverConfig(block_size=B, kernel_backend="fused"))
            store = int(plan.diag.nbytes + plan.tiles.nbytes)
            with stream_limit_env(2 * store + 1):
                resident = Solver(plan, "cuda")
            streamed = Solver(build_plan(a, 1, SolverConfig(block_size=B,
                                                            kernel_backend="fused_streamed")),
                              "cuda")
            if resident._fused.layout is not None or streamed._fused.layout is None:
                raise RuntimeError(f"side {side} B={B}: the executors did not take the "
                                   f"resident and the streamed form")
            b = torch.from_numpy(pad_rhs(rng.uniform(-1, 1, a.n).astype(np.float32),
                                         plan.bs)).cuda()
            if not torch.equal(resident.solve_blocks(b), streamed.solve_blocks(b)):
                raise RuntimeError(f"side {side} B={B}: streamed solve != resident bit for bit")
            turns = [device_time_ms(lambda s=s: s.solve_blocks(b), solves)
                     for s in (resident, streamed, streamed, resident)]
            r_ms, s_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            rows.append({"side": side, "n": a.n, "B": B, "levels": plan.n_levels,
                         "store_bytes": store, "resident_ms": r_ms, "streamed_ms": s_ms,
                         "ratio": s_ms / r_ms, "turns_ms": turns})
            del resident, streamed
    return rows


def crossover_bytes(rows: list) -> int | None:
    """The smallest store size S of the table such that streaming is no
    slower (ratio <= 1) at S and at every larger size measured: 0 when it is
    never slower, ``None`` when it is slower at the largest size."""
    ordered = sorted(rows, key=lambda r: r["store_bytes"])
    limit = None
    for r in reversed(ordered):
        if r["ratio"] > 1.0:
            break
        limit = r["store_bytes"]
    if limit == ordered[0]["store_bytes"]:
        return 0
    return limit


def format_row(r: dict) -> str:
    return (f"B={r['B']} side={r['side']} n={r['n']} levels={r['levels']} "
            f"store_bytes={r['store_bytes']} resident_ms={r['resident_ms']:.4f} "
            f"streamed_ms={r['streamed_ms']:.4f} ratio={r['ratio']:.4f} turns_ms="
            + ",".join(f"{t:.4f}" for t in r["turns_ms"]))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sides", type=int, nargs="+", default=list(SIDES))
    ap.add_argument("--blocks", type=int, nargs="+", default=list(BLOCKS))
    ap.add_argument("--solves", type=int, default=SOLVES)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("stream_crossover.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    rows = measure(args.sides, args.blocks, args.solves)
    for r in rows:
        print(format_row(r))
    print(f"crossover_bytes={crossover_bytes(rows)}")
    print(json.dumps(rows))


if __name__ == "__main__":
    main()
