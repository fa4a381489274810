"""Matrix-free preconditioned conjugate gradients (host driver).

The driver is deliberately dumb numpy glue: every flop that matters happens in
the compiled distributed matvec and the pair of compiled distributed triangular
solves passed in as callables. Supports a single RHS ``(n,)`` or a panel
``(n, R)`` — the panel runs R independent CG recurrences in lockstep (all
inner products are per-column), feeding the solver/SpMV multi-RHS paths so one
compiled solve serves the whole batch per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class KrylovResult:
    x: np.ndarray  # (n,) or (n, R)
    n_iters: int
    relres: np.ndarray  # final relative residual(s), shape () or (R,)
    converged: bool
    history: list  # max-over-RHS relative residual per iteration
    info: dict = dataclasses.field(default_factory=dict)


def _col_dot(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np.sum(u * v, axis=0)


def _norm(v: np.ndarray) -> np.ndarray:
    return np.sqrt(_col_dot(v, v))


def _safe_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """num/den with 0 where den == 0 (per-column Krylov breakdown guard)."""
    return np.where(den != 0.0, num / np.where(den == 0.0, 1.0, den), 0.0)


def pcg(
    matvec: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    *,
    psolve: Callable[[np.ndarray], np.ndarray] | None = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    x0: np.ndarray | None = None,
    agree: Callable[[np.ndarray], np.ndarray] | None = None,
) -> KrylovResult:
    """Solve SPD ``A x = b`` to ``||r|| <= tol * ||b||`` per RHS column.

    ``agree`` maps this process's relative residuals to the ones the stop
    test reads: on the ranks of a multi-device session, the group's
    elementwise max (:func:`repro_torch.core.comm.group_max`), so no rank
    stops alone and leaves the others in the next collective."""
    b = np.asarray(b, np.float64)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, np.float64).copy()
    r = b - np.asarray(matvec(x), np.float64) if x0 is not None else b.copy()
    bnorm = np.maximum(_norm(b), np.finfo(np.float64).tiny)
    z = np.asarray(psolve(r), np.float64) if psolve else r.copy()
    p = z.copy()
    rz = _col_dot(r, z)
    history = [float(np.max(_norm(r) / bnorm))]
    n_iters = 0
    for _ in range(maxiter):
        ap = np.asarray(matvec(p), np.float64)
        pap = _col_dot(p, ap)
        alpha = _safe_div(rz, pap)
        x = x + alpha * p
        r = r - alpha * ap
        n_iters += 1
        relres = _norm(r) / bnorm if agree is None else agree(_norm(r) / bnorm)
        history.append(float(np.max(relres)))
        if np.all(relres <= tol):
            return KrylovResult(x=x, n_iters=n_iters, relres=relres,
                                converged=True, history=history)
        z = np.asarray(psolve(r), np.float64) if psolve else r
        rz_new = _col_dot(r, z)
        beta = _safe_div(rz_new, rz)
        rz = rz_new
        p = z + beta * p
    return KrylovResult(x=x, n_iters=n_iters, relres=_norm(r) / bnorm,
                        converged=False, history=history)
