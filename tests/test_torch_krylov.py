"""Port Krylov layer: IC(0)-PCG and ILU(0)-BiCGStab iteration counts and
residual histories match the reference's, SpMV matches the reference and
scipy, and the preconditioner factors are identical."""
import numpy as np
import pytest
import scipy.sparse.linalg as spla

import strategies
from torch_parity import assert_arrays_identical, to_torch_csr
from repro.core import SolverConfig
from repro.core.solver import build_plan
from repro import krylov as jkrylov
from repro.api import SpTRSVContext as JContext
from repro.sparse import matrix as jmatrix
from repro.sparse import suite as jsuite
from repro_torch import krylov as tkrylov
from repro_torch.api import PlanOptions, SpTRSVContext
from repro_torch.core import solver as tsolver
from repro_torch.krylov import SpMV, solve_cg, solve_ic0_pcg, solve_ilu0_bicgstab
from repro_torch.sparse import suite as tsuite
from repro_torch.sparse.matrix import CSR, to_scipy

OPTS = PlanOptions(block_size=16)


@pytest.fixture(scope="module")
def spd_problem():
    a, b, full = strategies.spd_problem(side=18, seed=0)
    return to_torch_csr(a), b, full


@pytest.fixture(scope="module")
def reference_pcg(spd_problem):
    _, b, _ = spd_problem
    a, _, _ = strategies.spd_problem(side=18, seed=0)
    return jkrylov.solve_ic0_pcg(a, b, mesh=strategies.mesh1(), tol=1e-8,
                                 config=SolverConfig(block_size=16, kernel_backend="reference"))


def test_pcg_matches_reference_iterations_and_history(spd_problem, reference_pcg):
    a, b, full = spd_problem
    res = solve_ic0_pcg(a, b, device="cpu", config=OPTS, tol=1e-8)
    assert res.converged and reference_pcg.converged
    assert res.n_iters == reference_pcg.n_iters
    # float32 solves summed in different orders: the histories agree to a
    # few float32 ulps of the residual
    np.testing.assert_allclose(res.history, reference_pcg.history, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(res.x, spla.spsolve(full, b), rtol=1e-5, atol=1e-5)
    fwd, bwd = res.info["forward"], res.info["backward"]
    assert isinstance(fwd, tsolver.Solver) and isinstance(bwd, tsolver.Solver)
    assert fwd.n_solves == bwd.n_solves == res.n_iters
    assert bwd.plan.transpose and not fwd.plan.transpose
    assert res.info["context"].stats()["analyses"] == 1
    assert len(res.history) == res.n_iters + 1 and res.history[-1] <= 1e-8


def test_pcg_beats_cg_like_the_reference(spd_problem):
    a, b, _ = spd_problem
    ja, _, _ = strategies.spd_problem(side=18, seed=0)
    res_cg = solve_cg(a, b, device="cpu", config=OPTS, tol=1e-8)
    ref_cg = jkrylov.solve_cg(ja, b, mesh=strategies.mesh1(), tol=1e-8,
                              config=SolverConfig(block_size=16, kernel_backend="reference"))
    assert res_cg.converged and res_cg.n_iters == ref_cg.n_iters
    res_pcg = solve_ic0_pcg(a, b, device="cpu", config=OPTS, tol=1e-8)
    assert res_pcg.n_iters < res_cg.n_iters


def test_pcg_multirhs_matches_scipy(spd_problem):
    a, _, full = spd_problem
    B = np.random.default_rng(2).uniform(-1, 1, (a.n, 4))
    res = solve_ic0_pcg(a, B, device="cpu", config=OPTS, tol=1e-10, maxiter=300)
    assert res.converged and res.info["forward"].n_solves == res.n_iters
    x_ref = np.column_stack([spla.spsolve(full, B[:, j]) for j in range(4)])
    np.testing.assert_allclose(res.x, x_ref, rtol=1e-5, atol=1e-5)


def test_spmv_matches_reference_and_scipy(spd_problem):
    a, _, full = spd_problem
    ja, _, _ = strategies.spd_problem(side=18, seed=0)
    cfg = SolverConfig(block_size=16, kernel_backend="reference")
    ref = jkrylov.DistributedSpMV(build_plan(ja, 1, cfg), strategies.mesh1())
    for kernel in (None, "cuda"):
        spmv = SpMV(tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=16,
                                                                   kernel_backend=kernel)),
                    "cpu")
        rng = np.random.default_rng(1)
        for v in (rng.uniform(-1, 1, a.n), rng.uniform(-1, 1, (a.n, 3))):
            y = spmv.matvec(v)
            np.testing.assert_allclose(y, full @ v, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(y, ref.matvec(v), rtol=2e-5, atol=2e-5)
        assert spmv.n_matvecs == 2
    with pytest.raises(ValueError, match="transpose"):
        SpMV(tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=16), transpose=True),
             "cpu")


def test_preconditioner_factors_identical():
    ja, _, _ = strategies.spd_problem(side=12, seed=3)
    ta = to_torch_csr(ja)
    for name in ("ic0",):
        r, p = getattr(jkrylov, name)(ja), getattr(tkrylov, name)(ta)
        for f in ("row_ptr", "col_idx", "val"):
            assert_arrays_identical(getattr(r, f), getattr(p, f), f"{name}.{f}")
    full_r, full_p = jkrylov.symmetric_full_csr(ja), tkrylov.symmetric_full_csr(ta)
    for (r, p) in zip((full_r, *jkrylov.ilu0(full_r)), (full_p, *tkrylov.ilu0(full_p))):
        for f in ("row_ptr", "col_idx", "val"):
            assert_arrays_identical(getattr(r, f), getattr(p, f), f)
    tri = strategies.random_triangular(80, seed=1, m=200)
    spd_r, spd_p = jkrylov.spd_lower_from_triangular(tri), \
        tkrylov.spd_lower_from_triangular(to_torch_csr(tri))
    for f in ("row_ptr", "col_idx", "val"):
        assert_arrays_identical(getattr(spd_r, f), getattr(spd_p, f), f)
    u_r = jkrylov.precond.upper_as_reversed_lower(jkrylov.ilu0(full_r)[1])
    u_p = tkrylov.upper_as_reversed_lower(tkrylov.ilu0(full_p)[1])
    for f in ("row_ptr", "col_idx", "val"):
        assert_arrays_identical(getattr(u_r, f), getattr(u_p, f), f)


def test_preconditioner_refresh_no_reanalysis():
    a = tkrylov.spd_lower_from_triangular(tsuite.grid2d_factor(16, seed=1))
    b = np.random.default_rng(11).uniform(-1, 1, a.n)
    ctx = SpTRSVContext(device="cpu", options=OPTS)
    res = solve_ic0_pcg(a, b, context=ctx, tol=1e-8)
    a2 = CSR(n=a.n, row_ptr=a.row_ptr, col_idx=a.col_idx, val=a.val * 1.2)
    res.info["preconditioner"].refresh(a2)
    assert ctx.stats()["analyses"] == 1
    res2 = solve_ic0_pcg(a2, b, context=ctx, tol=1e-8)
    np.testing.assert_allclose(tkrylov.matvec_lower(a2, res2.x), b, rtol=0, atol=1e-5)
    assert ctx.stats()["analyses"] == 1


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, spd_problem):
    """``device=None`` means the card; without one every entry point raises
    instead of falling back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b, _ = spd_problem
    plan = tsolver.build_plan(a, 1, tsolver.SolverConfig(block_size=16))
    for call in (lambda: SpTRSVContext(), lambda: tsolver.Solver(plan),
                 lambda: SpMV(plan), lambda: solve_ic0_pcg(a, b),
                 lambda: solve_ilu0_bicgstab(a, b), lambda: SpTRSVContext(device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# ILU(0)-BiCGStab (the reference's tests/test_krylov.py and test_precond.py)
# ---------------------------------------------------------------------------

REF_CFG = SolverConfig(block_size=16, kernel_backend="reference")


@pytest.fixture(scope="module")
def reference_bicgstab():
    a, b, _ = strategies.spd_problem(side=18, seed=0)
    return jkrylov.solve_ilu0_bicgstab(a, b, mesh=strategies.mesh1(), tol=1e-8, config=REF_CFG)


@pytest.mark.parametrize("kernel,sched", [("reference", "levelset"), ("cuda", "levelset"),
                                          ("fused", "levelset"), ("fused_streamed", "levelset"),
                                          ("reference", "syncfree"), ("fused", "syncfree")])
def test_bicgstab_matches_reference_iterations_and_history(spd_problem, reference_bicgstab,
                                                           kernel, sched):
    """Two L/U preconditioner applications per iteration; the U sweep runs
    as a transpose solve of the reversed U^T under every backend."""
    a, b, full = spd_problem
    res = solve_ilu0_bicgstab(a, b, device="cpu", tol=1e-8,
                              config=PlanOptions(block_size=16, kernel=kernel, sched=sched))
    ref = reference_bicgstab
    assert res.converged and ref.converged and res.n_iters == ref.n_iters
    np.testing.assert_allclose(res.history, ref.history, rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(res.x, spla.spsolve(full, b), rtol=1e-5, atol=1e-5)
    fwd, bwd = res.info["forward"], res.info["backward"]
    assert fwd.n_solves == bwd.n_solves == 2 * res.n_iters
    assert bwd.plan.transpose and not fwd.plan.transpose
    assert res.info["context"].stats() == ref.info["context"].stats()


def test_ilu0_preconditioner_factors_identical():
    ja, _, _ = strategies.spd_problem(side=12, seed=3)
    full_r = jkrylov.symmetric_full_csr(ja)
    _, want = jkrylov.make_ilu0_preconditioner(full_r, mesh=strategies.mesh1(), config=REF_CFG)
    _, got = tkrylov.make_ilu0_preconditioner(tkrylov.symmetric_full_csr(to_torch_csr(ja)),
                                              device="cpu", config=OPTS)
    for key in ("lower", "upper"):
        for f in ("row_ptr", "col_idx", "val"):
            assert_arrays_identical(getattr(want[key], f), getattr(got[key], f), f"{key}.{f}")
    assert set(got) == set(want)
    assert isinstance(got["preconditioner"], tkrylov.ILU0Preconditioner)


def test_bicgstab_panel_matches_spsolve(spd_problem):
    a, _, full = spd_problem
    B = np.random.default_rng(4).uniform(-1, 1, (a.n, 2))
    res = solve_ilu0_bicgstab(a, B, device="cpu", config=OPTS, tol=1e-9, maxiter=300)
    assert res.converged and res.x.shape == (a.n, 2)
    assert res.info["forward"].n_solves == 2 * res.n_iters
    x_ref = np.column_stack([spla.spsolve(full, B[:, j]) for j in range(2)])
    np.testing.assert_allclose(res.x, x_ref, rtol=1e-5, atol=1e-5)


def test_ilu0_refresh_no_reanalysis_like_the_reference():
    """A refresh re-factorizes on the same analysis: the context's counters
    equal the reference context's after the same calls, and a new pattern
    raises."""
    ja = jkrylov.spd_lower_from_triangular(jsuite.grid2d_factor(16, seed=1))
    ja2 = jmatrix.CSR(n=ja.n, row_ptr=ja.row_ptr, col_idx=ja.col_idx, val=ja.val * 1.2)
    a, a2 = to_torch_csr(ja), to_torch_csr(ja2)
    b = np.random.default_rng(11).uniform(-1, 1, a.n)
    rctx = JContext(mesh=strategies.mesh1(), options=REF_CFG)
    ref = jkrylov.solve_ilu0_bicgstab(ja, b, context=rctx, tol=1e-8)
    ref.info["preconditioner"].refresh(jkrylov.symmetric_full_csr(ja2))
    ctx = SpTRSVContext(device="cpu", options=OPTS)
    res = solve_ilu0_bicgstab(a, b, context=ctx, tol=1e-8)
    res.info["preconditioner"].refresh(tkrylov.symmetric_full_csr(a2))
    assert ctx.stats() == rctx.stats() and ctx.stats()["analyses"] == 1
    res2 = solve_ilu0_bicgstab(a2, b, context=ctx, tol=1e-8)
    np.testing.assert_allclose(tkrylov.matvec_lower(a2, res2.x), b, rtol=0, atol=1e-5)
    assert ctx.stats()["analyses"] == 1
    with pytest.raises(ValueError, match="pattern"):
        res2.info["preconditioner"].refresh(tkrylov.symmetric_full_csr(
            tkrylov.spd_lower_from_triangular(tsuite.grid2d_factor(15, seed=1))))


@pytest.mark.parametrize("kernel", ["reference", "fused"])
def test_pcg_syncfree_converges(kernel):
    """The reference's ``test_pcg_all_solver_modes`` syncfree case, in both
    forms of the port's syncfree executor."""
    a = tkrylov.spd_lower_from_triangular(tsuite.grid2d_factor(12, seed=5))
    b = np.random.default_rng(6).uniform(-1, 1, a.n)
    res = solve_ic0_pcg(a, b, device="cpu", tol=1e-8,
                        config=PlanOptions(block_size=8, sched="syncfree", kernel=kernel))
    assert res.converged
    full = to_scipy(tkrylov.symmetric_full_csr(a)).tocsc()
    np.testing.assert_allclose(res.x, spla.spsolve(full, b), rtol=1e-5, atol=1e-5)
