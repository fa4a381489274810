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

``solve_ilu0_bicgstab(A, b, ...)`` runs BiCGStab with an ILU(0)
preconditioner of the full symmetric expansion of ``A``: an L/U pair of
solves per application, two applications per iteration. The U sweep is a
transpose solve of the reversed ``U^T``, so every backend serves it as a
lower solve.

Every entry point takes ``group=`` (a ``torch.distributed`` group, one rank
per device; or a ``context`` built with one): the plans are D-device plans,
the SpMV and the solves exchange over the group and give every rank the
same bits, and the loop runs replicated on every rank, its stop test on the
group's largest residual, so all ranks take the same iterations.

Preconditioners are durable objects: :class:`IC0Preconditioner` /
:class:`ILU0Preconditioner` support ``refresh(new_matrix)``, which re-runs
the numeric factorization on new values of the SAME pattern and re-arms the
executors in place.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.api import PlanOptions, SpTRSVContext, as_options
from repro_torch.core import comm
from repro_torch.core.solver import SolverConfig
from repro_torch.krylov.bicgstab import bicgstab
from repro_torch.krylov.cg import KrylovResult, pcg
from repro_torch.krylov.precond import ic0, ilu0, symmetric_full_csr, upper_as_reversed_lower
from repro_torch.krylov.spmv import SpMV
from repro_torch.sparse.matrix import CSR


def _context(device, config, context, group=None) -> SpTRSVContext:
    if context is not None:
        return context
    return SpTRSVContext(device=device, options=as_options(config), group=group)


def _agree(ctx: SpTRSVContext):
    """The stop test's agreement for ``ctx``'s group: the group's max of the
    relative residuals, one ``all_reduce`` (of a value per panel column) an
    iteration; the residuals themselves without a group."""
    return functools.partial(comm.group_max, group=ctx.group, device=ctx.device)


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


class ILU0Preconditioner:
    """``M^{-1} r = U^-1 L^-1 r`` with ILU(0) factors of a full CSR.

    The unit-lower factor lives on the strict-lower + diagonal pattern and
    shares that pattern's symbolic analysis (tag ``"ilu0-L"``); the U sweep
    runs as a transpose solve of the reversed ``U^T`` under tag ``"ilu0-U"``
    — on a symmetric pattern that too shares the SAME analysis (``U^T`` has
    L's pattern), so the whole L/U pair costs one partition.
    """

    def __init__(self, ctx: SpTRSVContext, a_full: CSR):
        self.ctx = ctx
        self._lower_handle = None
        self._upper_handle = None
        self._factorize(a_full)

    def _factorize(self, a_full: CSR) -> None:
        self.lower, self.upper = ilu0(a_full)
        # after the first factorization, pass the handles explicitly so a
        # pattern change raises instead of silently re-analysing
        self._lower_handle = self.ctx.factorize(
            self.lower, self._lower_handle, tag="ilu0-L")
        self._upper_handle = self.ctx.factorize(
            upper_as_reversed_lower(self.upper), self._upper_handle, tag="ilu0-U")

    def refresh(self, a_full: CSR) -> "ILU0Preconditioner":
        self._factorize(a_full)
        return self

    def __call__(self, r: np.ndarray) -> np.ndarray:
        y = self.ctx.solve(self._lower_handle, r)
        return self.ctx.solve(self._upper_handle, y, transpose=True)


def make_ic0_preconditioner(
    a_lower: CSR, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None,
    context: SpTRSVContext | None = None, group=None,
) -> tuple:
    """IC(0)-factorize and wire the solve pair ``M^{-1} r = L^-T L^-1 r``.

    Returns ``(psolve, handles)``: ``psolve`` is an :class:`IC0Preconditioner`
    (callable, refreshable); ``handles`` holds ``factor``, the ``forward`` and
    ``backward`` executors (with ``n_solves`` audit counters), ``context``,
    ``handle`` and ``preconditioner``.
    """
    ctx = _context(device, config, context, group)
    pre = IC0Preconditioner(ctx, a_lower)
    return pre, {
        "factor": pre.factor,
        "forward": ctx.executor(pre.handle),
        "backward": ctx.executor(pre.handle, transpose=True),
        "context": ctx, "handle": pre.handle, "preconditioner": pre,
    }


def make_ilu0_preconditioner(
    a_full: CSR, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None,
    context: SpTRSVContext | None = None, group=None,
) -> tuple:
    """ILU(0)-factorize a full CSR and wire ``M^{-1} r = U^-1 L^-1 r``.

    Returns ``(psolve, handles)``: ``psolve`` is an :class:`ILU0Preconditioner`;
    ``handles`` holds the ``lower`` and ``upper`` factors, the ``forward`` (L)
    and ``backward`` (U) executors, ``context`` and ``preconditioner``.
    """
    ctx = _context(device, config, context, group)
    pre = ILU0Preconditioner(ctx, a_full)
    return pre, {
        "lower": pre.lower, "upper": pre.upper,
        "forward": ctx.executor(pre._lower_handle),
        "backward": ctx.executor(pre._upper_handle, transpose=True),
        "context": ctx, "preconditioner": pre,
    }


def solve_cg(
    a_lower: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None, tol: float = 1e-8,
    maxiter: int = 2000, context: SpTRSVContext | None = None, group=None,
) -> KrylovResult:
    """Unpreconditioned CG baseline (SpMV only, no triangular solves)."""
    ctx = _context(device, config, context, group)
    spmv = SpMV(ctx.plan(ctx.analyse(a_lower)), ctx.device, ctx.group)
    res = pcg(spmv.matvec, b, tol=tol, maxiter=maxiter, agree=_agree(ctx))
    res.info.update(spmv=spmv, context=ctx)
    return res


def solve_ic0_pcg(
    a_lower: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None, tol: float = 1e-8,
    maxiter: int = 2000, context: SpTRSVContext | None = None, group=None,
) -> KrylovResult:
    """PCG with an IC(0) preconditioner — the paper's amortized regime.

    Exactly ONE analysis happens for ``a_lower``'s pattern: the SpMV reads
    the analysis plan with A's values, then the IC(0) factor is numerically
    refreshed into a tagged handle on the same analysis and both triangular
    sweeps solve against it every iteration. ``b`` may be ``(n,)`` or an
    ``(n, R)`` panel.
    """
    ctx = _context(device, config, context, group)
    spmv = SpMV(ctx.plan(ctx.analyse(a_lower)), ctx.device, ctx.group)
    psolve, handles = make_ic0_preconditioner(a_lower, context=ctx)
    res = pcg(spmv.matvec, b, psolve=psolve, tol=tol, maxiter=maxiter,
              agree=_agree(ctx))
    res.info.update(spmv=spmv, **handles)
    return res


def solve_ilu0_bicgstab(
    a_lower: CSR, b: np.ndarray, *, device: str | torch.device | None = None,
    config: SolverConfig | PlanOptions | None = None, tol: float = 1e-8,
    maxiter: int = 2000, context: SpTRSVContext | None = None, group=None,
) -> KrylovResult:
    """BiCGStab with an ILU(0) preconditioner built from the full symmetric
    expansion of ``a_lower``. The unit-lower factor shares ``a_lower``'s
    pattern (and therefore its analysis); the reversed U's transpose plan
    is a lazy extension of a handle on that same analysis."""
    ctx = _context(device, config, context, group)
    spmv = SpMV(ctx.plan(ctx.analyse(a_lower)), ctx.device, ctx.group)
    psolve, handles = make_ilu0_preconditioner(symmetric_full_csr(a_lower), context=ctx)
    res = bicgstab(spmv.matvec, b, psolve=psolve, tol=tol, maxiter=maxiter,
                   agree=_agree(ctx))
    res.info.update(spmv=spmv, **handles)
    return res
