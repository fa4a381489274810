"""Matrix-free preconditioned BiCGStab (a loop on the host).

Right-preconditioned van der Vorst recurrence: the preconditioner application
``M^{-1} v`` is an L/U pair of triangular solves, invoked twice per
iteration — double the SpTRSV pressure of PCG. Panels ``(n, R)`` run
column-lockstep like :func:`repro_torch.krylov.cg.pcg`.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.krylov.cg import KrylovResult, _col_dot, _norm, _safe_div


def bicgstab(
    matvec: Callable[[np.ndarray], np.ndarray],
    b: np.ndarray,
    *,
    psolve: Callable[[np.ndarray], np.ndarray] | None = None,
    tol: float = 1e-8,
    maxiter: int = 1000,
    x0: np.ndarray | None = None,
    agree: Callable[[np.ndarray], np.ndarray] | None = None,
) -> KrylovResult:
    """Solve ``A x = b`` (A square, possibly nonsymmetric) per RHS column;
    ``agree`` as in :func:`repro_torch.krylov.cg.pcg`."""
    b = np.asarray(b, np.float64)
    x = np.zeros_like(b) if x0 is None else np.asarray(x0, np.float64).copy()
    r = b - np.asarray(matvec(x), np.float64) if x0 is not None else b.copy()
    r_hat = r.copy()  # shadow residual
    bnorm = np.maximum(_norm(b), np.finfo(np.float64).tiny)
    rho = alpha = omega = np.ones(b.shape[1:] or ())
    v = p = np.zeros_like(b)
    history = [float(np.max(_norm(r) / bnorm))]
    n_iters = 0
    for _ in range(maxiter):
        rho_new = _col_dot(r_hat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        ph = np.asarray(psolve(p), np.float64) if psolve else p
        v = np.asarray(matvec(ph), np.float64)
        alpha = _safe_div(rho, _col_dot(r_hat, v))
        s = r - alpha * v
        sh = np.asarray(psolve(s), np.float64) if psolve else s
        t = np.asarray(matvec(sh), np.float64)
        omega = _safe_div(_col_dot(t, s), _col_dot(t, t))
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        n_iters += 1
        relres = _norm(r) / bnorm if agree is None else agree(_norm(r) / bnorm)
        history.append(float(np.max(relres)))
        if np.all(relres <= tol):
            return KrylovResult(x=x, n_iters=n_iters, relres=relres,
                                converged=True, history=history)
    return KrylovResult(x=x, n_iters=n_iters, relres=_norm(r) / bnorm,
                        converged=False, history=history)
