"""The port's single-device syncfree executor on the CPU against the
reference's ``_syncfree_device_fn`` (``DistributedSolver`` on a one-device
mesh): the frontier width ladder, dyadic solves bit for bit in both forms
(dense scan under ``reference``/``cuda``, frontier-bucketed under
``fused``/``fused_streamed``), real values within rtol = atol = 2e-4 (the
reference's own solve tolerance), the reference's degenerate cases, refresh,
the per-solve call counts, and the refusals that remain.
"""
import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import strategies
from torch_parity import assert_dispatch_stats_match, to_torch_csr
from repro.core import DistributedSolver, SolverConfig, build_plan, dispatch_stats
from repro.core.solver import _frontier_ladder as ref_frontier_ladder
from repro.sparse.matrix import reference_solve, to_scipy
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import solver as tsolver
from repro_torch.core.solver import level_widths
from repro_torch.kernels import ops
from repro_torch.sparse.matrix import CSR

TOL = dict(rtol=2e-4, atol=2e-4)
BACKENDS = ("reference", "cuda", "fused", "fused_streamed")
FRONTIER = ("fused", "fused_streamed")


def _rhs(n: int, form: str, seed: int = 1) -> np.ndarray:
    if form == "panel":
        return np.stack([strategies.dyadic_rhs(n, seed=seed + k) for k in range(3)], axis=1)
    return strategies.dyadic_rhs(n, seed=seed)


@functools.lru_cache(maxsize=None)
def _reference_dyadic(matrix: str, B: int, form: str, frontier: bool) -> np.ndarray:
    """The reference's syncfree solve, dense (``reference``) or frontier
    (``fused``), cached per case."""
    a = strategies.EXACT_MATRICES[matrix]()
    cfg = SolverConfig(block_size=B, sched="syncfree",
                       kernel_backend="fused" if frontier else "reference")
    plan = build_plan(a, 1, cfg, transpose=form == "transpose")
    return DistributedSolver(plan, strategies.mesh1()).solve(_rhs(a.n, form))


def _solver(a, B: int, kernel: str | None, *, transpose: bool = False, group: int = 0):
    cfg = tsolver.SolverConfig(block_size=B, sched="syncfree", kernel_backend=kernel,
                               gemv_group=group)
    return tsolver.Solver(tsolver.build_plan(to_torch_csr(a), 1, cfg, transpose=transpose),
                          "cpu")


def test_frontier_ladder_identical():
    for cap in range(1, 5001):
        assert tsolver._frontier_ladder(cap) == ref_frontier_ladder(cap), cap
    assert len(tsolver._frontier_ladder(5000)) <= tsolver.MAX_BUCKETS


@pytest.mark.parametrize("matrix", sorted(strategies.EXACT_MATRICES))
@pytest.mark.parametrize("B", [3, 8])
@pytest.mark.parametrize("form", ["forward", "transpose", "panel"])
@pytest.mark.parametrize("kernel", BACKENDS)
@pytest.mark.parametrize("group", [0, 8])
def test_bit_identical_to_reference_on_dyadic(matrix, B, form, kernel, group):
    """Every intermediate is exact in float32, so both forms give the
    reference's bits; ``cuda`` runs the kernel wrappers' plain versions on
    CPU tensors."""
    a = strategies.EXACT_MATRICES[matrix]()
    solver = _solver(a, B, kernel, transpose=form == "transpose", group=group)
    assert solver._syncfree.frontier == (kernel in FRONTIER)
    x = solver.solve(_rhs(a.n, form))
    np.testing.assert_array_equal(x, _reference_dyadic(matrix, B, form, kernel in FRONTIER))


def test_bit_identical_to_reference_pallas_interpret():
    """The reference's syncfree executor on its Pallas kernels (interpret
    mode on the CPU) gives the port's bits."""
    a = strategies.EXACT_MATRICES["skewed"]()
    b = _rhs(a.n, "forward")
    plan = build_plan(a, 1, SolverConfig(block_size=8, sched="syncfree", kernel_backend="pallas"))
    want = DistributedSolver(plan, strategies.mesh1()).solve(b)
    for kernel in ("cuda", "fused"):
        np.testing.assert_array_equal(_solver(a, 8, kernel).solve(b), want)


@functools.lru_cache(maxsize=None)
def _reference_real(name: str) -> np.ndarray:
    a = strategies.SOLVER_MATRICES[name]()
    b = np.random.default_rng(3).uniform(-1, 1, a.n)
    plan = build_plan(a, 1, SolverConfig(block_size=16, sched="syncfree",
                                         kernel_backend="reference"))
    return DistributedSolver(plan, strategies.mesh1()).solve(b)


@pytest.mark.parametrize("name", sorted(strategies.SOLVER_MATRICES))
@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_real_values_match_reference_and_scipy(name, kernel):
    a = strategies.SOLVER_MATRICES[name]()
    rng = np.random.default_rng(3)
    b, panel = rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))
    x = _solver(a, 16, kernel).solve(b)
    np.testing.assert_allclose(x, _reference_real(name), **TOL)
    np.testing.assert_allclose(x, reference_solve(a, b), **TOL)
    np.testing.assert_allclose(_solver(a, 16, kernel).solve(panel), reference_solve(a, panel),
                               **TOL)
    xt = _solver(a, 16, kernel, transpose=True).solve(b)
    np.testing.assert_allclose(
        xt, spla.spsolve_triangular(to_scipy(a).T.tocsr(), b, lower=False), **TOL)


@pytest.fixture
def op_calls(monkeypatch):
    """Counts of ``ops.batched_block_trsv`` / ``batched_block_gemv`` calls
    (the CPU wrappers run plain versions and count no launches)."""
    calls = {"trsv": 0, "gemv": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops, "batched_block_trsv", counted("trsv", ops.batched_block_trsv))
    monkeypatch.setattr(ops, "batched_block_gemv", counted("gemv", ops.batched_block_gemv))
    return calls


@pytest.mark.parametrize("build,b,expect", [
    (strategies.empty_matrix, np.zeros(0), np.zeros(0)),
    (strategies.diagonal_matrix, np.arange(1.0, 25.0), np.arange(1.0, 25.0) / 2.0),
    (strategies.single_entry_matrix, np.array([6.0]), np.array([2.0])),
])
@pytest.mark.parametrize("kernel", BACKENDS)
def test_degenerate_matrices(build, b, expect, kernel, op_calls):
    """``tests/test_degenerate.py``'s syncfree cases: an empty plan returns
    an empty ``x`` and calls no block op; a diagonal-only plan (no tile but
    the zero pad) and a single entry solve exactly."""
    a = build()
    solver = _solver(a, 8, kernel)
    np.testing.assert_array_equal(solver.solve(b), expect.astype(np.float32))
    assert solver.solve(np.zeros((a.n, 3))).shape == (a.n, 3)
    want = DistributedSolver(build_plan(a, 1, SolverConfig(block_size=8, sched="syncfree")),
                             strategies.mesh1()).solve(b)
    np.testing.assert_array_equal(solver.solve(b), want)
    if a.n == 0:
        assert op_calls == {"trsv": 0, "gemv": 0} and solver._syncfree.sweeps == 0


@pytest.mark.parametrize("kernel", BACKENDS)
@pytest.mark.parametrize("transpose", [False, True])
def test_one_sweep_per_level_and_block_op_calls(kernel, transpose, op_calls):
    """A sweep solves exactly one block level: ``n_levels`` sweeps and host
    reads per solve, one TRSV call per sweep; the dense scan calls the GEMV
    every sweep, the frontier form only where the level sources tiles."""
    a = strategies.SOLVER_MATRICES["levelled"]()
    solver = _solver(a, 16, kernel, transpose=transpose)
    plan = solver.plan
    solver.solve(np.ones(a.n))
    sf = solver._syncfree
    assert sf.sweeps == sf.host_reads == plan.n_levels
    with_tiles = int((level_widths(plan)[:, 1] > 0).sum())
    assert op_calls == {"trsv": plan.n_levels,
                        "gemv": with_tiles if sf.frontier else plan.n_levels}


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_refresh_new_values_and_structural_check(kernel):
    a = strategies.SOLVER_MATRICES["levelled"]()
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx,
             val=a.val * (1.0 + 0.25 * np.sin(np.arange(a.nnz))))
    solver = _solver(a, 16, kernel)
    b = np.random.default_rng(7).uniform(-1, 1, a.n)
    solver.solve(b)
    solver.refresh(tsolver.refresh_plan(solver.plan, to_torch_csr(a2)))
    np.testing.assert_allclose(solver.solve(b), reference_solve(a2, b), **TOL)
    other = _solver(strategies.SOLVER_MATRICES["chain"](), 16, kernel).plan
    with pytest.raises(ValueError, match="identical symbolic schedule"):
        solver.refresh(other)
    indeg = solver.plan.indeg.copy()
    indeg[0] += 1
    with pytest.raises(ValueError, match="identical symbolic schedule"):
        solver.refresh(dataclasses.replace(solver.plan, indeg=indeg))


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_stuck_plan_raises_instead_of_spinning(kernel):
    """A row whose in-degree can never be met leaves rows unsolved with an
    empty frontier: the executor raises, naming the plan."""
    a = strategies.EXACT_MATRICES["skewed"]()
    plan = _solver(a, 8, kernel).plan
    indeg = plan.indeg.copy()
    indeg[plan.bs.nb - 1] += 1
    solver = tsolver.Solver(dataclasses.replace(plan, indeg=indeg), "cpu")
    with pytest.raises(RuntimeError, match="syncfree plan .* none ready"):
        solver.solve(np.ones(a.n))


@pytest.mark.parametrize("kernel", BACKENDS)
def test_dispatch_stats_match_reference(kernel):
    a = strategies.SOLVER_MATRICES["levelled"]()
    ref_kernel = {"cuda": "pallas"}.get(kernel, kernel)  # the reference's name for it
    ref = build_plan(a, 1, SolverConfig(block_size=16, sched="syncfree",
                                        kernel_backend=ref_kernel))
    port = tsolver.build_plan(to_torch_csr(a), 1,
                              tsolver.SolverConfig(block_size=16, sched="syncfree",
                                                   kernel_backend=kernel))
    assert_dispatch_stats_match(dispatch_stats(ref), ref, tsolver.dispatch_stats(port))


@pytest.mark.parametrize("kernel", [None, "fused"])
def test_multi_device_syncfree_still_raises(kernel):
    """A multi-device syncfree plan runs on a group of ``n_devices`` ranks
    (``tests/test_torch_zerocopy.py``); without one it raises
    ``ValueError`` asking for it."""
    a = to_torch_csr(strategies.EXACT_MATRICES["skewed"]())
    plan = tsolver.build_plan(a, 2, tsolver.SolverConfig(block_size=8, sched="syncfree",
                                                         kernel_backend=kernel))
    with pytest.raises(ValueError, match="group of 2 ranks"):
        tsolver.Solver(plan, "cpu")


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_session_solves_and_factorizes(kernel):
    """Through ``SpTRSVContext``: forward and transpose on one analysis, and
    a factorize re-arms both executors."""
    a = strategies.SOLVER_MATRICES["grid"]()
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx, val=a.val * 1.5)
    ctx = SpTRSVContext(device="cpu", options=PlanOptions(block_size=16, sched="syncfree",
                                                          kernel=kernel))
    h = ctx.analyse(a)
    b = np.random.default_rng(2).uniform(-1, 1, a.n)
    np.testing.assert_allclose(ctx.solve(h, b), reference_solve(a, b), **TOL)
    ctx.solve(h, b, transpose=True)
    ctx.factorize(a2, h)
    np.testing.assert_allclose(ctx.solve(h, b), reference_solve(a2, b), **TOL)
    np.testing.assert_allclose(
        ctx.solve(h, b, transpose=True),
        spla.spsolve_triangular(to_scipy(a2).T.tocsr(), b, lower=False), **TOL)
    assert ctx.stats()["analyses"] == 1


@pytest.mark.parametrize("cap", [1, 7, 37, 300, 4096, 5000])
def test_frontier_width_is_the_reference_branch(cap):
    """The frontier's launch width is the ladder rung the reference's
    ``lax.switch`` selects (``sum(ladder < count)``) for every count up to
    the cap; a larger frontier raises, naming the plan."""
    s = _solver(strategies.EXACT_MATRICES["banded"](), 3, "fused")._syncfree
    ladder = tsolver._frontier_ladder(cap)
    for count in range(1, cap + 1):
        assert s.width(ladder, count) == ladder[int(np.sum(np.array(ladder) < count))], count
    with pytest.raises(RuntimeError, match="syncfree plan"):
        s.width(ladder, cap + 1)
