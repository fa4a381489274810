"""Suite-wide verifier sweep: ``python -m repro_torch.verify.sweep [level]``.

Builds a plan for every (matrix x partition x sched x comm x kernel x
device count x transpose) combination of :func:`sweep_grid` over the
matrices of :func:`sweep_matrices` and runs
:func:`repro_torch.verify.verify_plan` on each, ``strict`` by default: the
legality gate over every plan the builders produce.

Plan construction is host numpy, so multi-device plans build and verify
without any device. Exit status: 0 when every plan verifies clean, 1
otherwise (the findings are printed per failing combination).
"""
from __future__ import annotations

import itertools
import sys

import numpy as np

from repro_torch.sparse import suite
from repro_torch.sparse.matrix import CSR, lower_triangular_from_coo


def sweep_matrices() -> dict:
    """The verification corpus: the suite regimes plus the degenerate
    structures that have hidden edge cases before (the same corpus as the
    reference's sweep)."""
    rng = np.random.default_rng(11)
    return {
        "skewed": suite.random_levelled(400, 8, 4.0, seed=6),
        "banded": suite.random_levelled(300, 8, 4.0, seed=7, locality=0.8),
        "chain": suite.chain(150),
        "grid": suite.grid2d_factor(18, seed=1),
        "parallel": suite.block_diagonal_parallel(300, 12, 3.0, seed=2),
        "random": lower_triangular_from_coo(
            200, rng.integers(0, 200, 600), rng.integers(0, 200, 600),
            rng=rng),
        "empty": CSR(n=0, row_ptr=np.zeros(1, np.int64),
                     col_idx=np.zeros(0, np.int32),
                     val=np.zeros(0, np.float32)),
        "diagonal": CSR(n=24, row_ptr=np.arange(25, dtype=np.int64),
                        col_idx=np.arange(24, dtype=np.int32),
                        val=np.full(24, 2.0, np.float32)),
        "single": CSR(n=1, row_ptr=np.array([0, 1], np.int64),
                      col_idx=np.zeros(1, np.int32),
                      val=np.array([3.0], np.float32)),
    }


def sweep_grid(devices: tuple = (1, 4, 8)) -> list:
    """All (partition, sched, comm, kernel, n_devices, transpose) combos."""
    from repro_torch.core.partition import STRATEGIES
    from repro_torch.core.solver import COMM_MODES, SCHED_MODES

    kernels = (None, "fused", "fused_streamed")
    return list(itertools.product(
        STRATEGIES, SCHED_MODES, COMM_MODES, kernels, devices, (False, True)))


def run_sweep(level: str = "strict", block_size: int = 8, out=sys.stdout, *,
              matrices: dict | None = None, grid: list | None = None) -> int:
    """Verify every combination; returns the exit status (0: all clean).
    ``matrices`` and ``grid`` default to :func:`sweep_matrices` and
    :func:`sweep_grid`."""
    from repro_torch.core.solver import SolverConfig, build_plan
    from repro_torch.verify import verify_plan

    matrices = sweep_matrices() if matrices is None else matrices
    grid = sweep_grid() if grid is None else grid
    n_plans = 0
    failures = []
    for name, a in matrices.items():
        for part, sched, comm, kernel, D, transpose in grid:
            cfg = SolverConfig(block_size=block_size, sched=sched, comm=comm,
                               partition=part, kernel_backend=kernel)
            plan = build_plan(a, D, cfg, transpose=transpose)
            report = verify_plan(plan, level=level)
            n_plans += 1
            if not report.passed:
                combo = (f"{name} x {part}/{sched}/{comm}/"
                         f"{kernel or 'default'}/D={D}"
                         f"{'/transpose' if transpose else ''}")
                failures.append((combo, report))
    for combo, report in failures:
        print(f"FAIL {combo}: {report.summary()}", file=out)
        for f in report.findings:
            print(f"  {f}", file=out)
    verdict = "FAIL" if failures else "PASS"
    print(f"[verify.sweep] {verdict}: {n_plans} plans "
          f"({len(matrices)} matrices x {len(grid)} combos) at "
          f"level={level}, {len(failures)} failing", file=out)
    return 1 if failures else 0


def main(argv: list | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return run_sweep(argv[0] if argv else "strict")


if __name__ == "__main__":
    raise SystemExit(main())
