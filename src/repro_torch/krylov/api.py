"""Front door of the Krylov subsystem — a client of the session API.

``solve_ic0_pcg(A, b, ...)`` takes the lower-triangular half of a symmetric
matrix and runs the amortized regime through one
:class:`repro_torch.api.SpTRSVContext`: the pattern is **analysed once**, the
IC(0) factor is **factorized** into that same analysis as a numeric refresh
(zero fill means the factor shares the matrix pattern exactly), and the
forward/backward triangular sweeps are context **solves** on cached
executors — the L^T sweep is a lazy transpose extension of the same handle.
Every result carries the live context and executors in ``result.info`` so
callers can audit analysis and invocation counts.

ILU(0)-BiCGStab is not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api import PlanOptions, SpTRSVContext, as_options
from repro_torch.core.solver import SolverConfig
from repro_torch.krylov.cg import KrylovResult, pcg
from repro_torch.krylov.precond import ic0
from repro_torch.krylov.spmv import SpMV
from repro_torch.sparse.matrix import CSR


def _context(device, config, context) -> SpTRSVContext:
    if context is not None:
        return context
    return SpTRSVContext(device=device, options=as_options(config))


class IC0Preconditioner:
    """``M^{-1} r = L^-T L^-1 r`` with IC(0) ``L`` on ``a_lower``'s pattern.

    Both sweeps run through the context's executors on ONE analysis — the
    factor handle is tagged ``"ic0"``, so it shares the pattern's symbolic
    analysis with the matrix itself but holds the factor's values
    independently. ``refresh(a_lower_new)`` refactorizes new values on the
    same pattern and re-arms the executors without re-partitioning.
    """

    TAG = "ic0"

    def __init__(self, ctx: SpTRSVContext, a_lower: CSR):
        self.ctx = ctx
        self.factor = ic0(a_lower)
        self.handle = ctx.factorize(self.factor, tag=self.TAG)

    def refresh(self, a_lower: CSR) -> "IC0Preconditioner":
        self.factor = ic0(a_lower)
        self.ctx.factorize(self.factor, self.handle)
        return self

    def __call__(self, r: np.ndarray) -> np.ndarray:
        y = self.ctx.solve(self.handle, r)
        return self.ctx.solve(self.handle, y, transpose=True)


def make_ic0_preconditioner(
    a_lower: CSR, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None,
    context: SpTRSVContext | None = None,
) -> tuple:
    """IC(0)-factorize and wire the solve pair ``M^{-1} r = L^-T L^-1 r``.

    Returns ``(psolve, handles)``: ``psolve`` is an :class:`IC0Preconditioner`
    (callable, refreshable); ``handles`` holds ``factor``, the ``forward`` and
    ``backward`` executors (with ``n_solves`` audit counters), ``context``,
    ``handle`` and ``preconditioner``.
    """
    ctx = _context(device, config, context)
    pre = IC0Preconditioner(ctx, a_lower)
    return pre, {
        "factor": pre.factor,
        "forward": ctx.executor(pre.handle),
        "backward": ctx.executor(pre.handle, transpose=True),
        "context": ctx, "handle": pre.handle, "preconditioner": pre,
    }


def solve_cg(
    a_lower: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None, tol: float = 1e-8,
    maxiter: int = 2000, context: SpTRSVContext | None = None,
) -> KrylovResult:
    """Unpreconditioned CG baseline (SpMV only, no triangular solves)."""
    ctx = _context(device, config, context)
    spmv = SpMV(ctx.plan(ctx.analyse(a_lower)), ctx.device)
    res = pcg(spmv.matvec, b, tol=tol, maxiter=maxiter)
    res.info.update(spmv=spmv, context=ctx)
    return res


def solve_ic0_pcg(
    a_lower: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None, tol: float = 1e-8,
    maxiter: int = 2000, context: SpTRSVContext | None = None,
) -> KrylovResult:
    """PCG with an IC(0) preconditioner — the paper's amortized regime.

    Exactly ONE analysis happens for ``a_lower``'s pattern: the SpMV reads
    the analysis plan with A's values, then the IC(0) factor is numerically
    refreshed into a tagged handle on the same analysis and both triangular
    sweeps solve against it every iteration. ``b`` may be ``(n,)`` or an
    ``(n, R)`` panel.
    """
    ctx = _context(device, config, context)
    spmv = SpMV(ctx.plan(ctx.analyse(a_lower)), ctx.device)
    psolve, handles = make_ic0_preconditioner(a_lower, context=ctx)
    res = pcg(spmv.matvec, b, psolve=psolve, tol=tol, maxiter=maxiter)
    res.info.update(spmv=spmv, **handles)
    return res
