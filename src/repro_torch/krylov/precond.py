"""Numeric IC(0)/ILU(0) factorization on an existing sparsity (paper §I).

The paper's whole case for fast SpTRSV is that it is the inner kernel of
preconditioner *application*; these host-side factorizations produce the
triangular factors whose solves the :class:`~repro_torch.core.solver.Solver`
then executes hundreds of times per Krylov run. Zero fill-in: both factors
reuse the input pattern exactly, so one block analysis/partition/compile is
valid for the factor whenever it was valid for the matrix.

Conventions (matching :mod:`repro_torch.sparse.matrix`): a symmetric (SPD) matrix is
represented by its lower-triangular half including the diagonal, col indices
ascending per row with the diagonal entry last.
"""
from __future__ import annotations

import numpy as np

from repro_torch.sparse.matrix import CSR, csr_transpose, to_scipy


def spd_lower_from_triangular(tri: CSR) -> CSR:
    """Lower half of a strictly diagonally dominant SPD matrix on ``tri``'s
    pattern: off-diagonal values are kept, the diagonal is rebuilt as
    ``1 + sum_j |A_ij| (j != i)`` over the *symmetrized* row — dominance of a
    symmetric matrix guarantees positive definiteness, which IC(0) needs."""
    n = tri.n
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(tri.row_ptr))
    cols = tri.col_idx.astype(np.int64)
    off = rows != cols
    o_rows, o_cols, o_vals = rows[off], cols[off], tri.val[off].astype(np.float64)
    dom = np.zeros(n)
    np.add.at(dom, o_rows, np.abs(o_vals))
    np.add.at(dom, o_cols, np.abs(o_vals))  # the mirrored upper entries
    diag = 1.0 + dom
    all_rows = np.concatenate([o_rows, np.arange(n)])
    all_cols = np.concatenate([o_cols, np.arange(n)])
    all_vals = np.concatenate([o_vals, diag])
    order = np.lexsort((all_cols, all_rows))
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(all_rows, minlength=n), out=row_ptr[1:])
    return CSR(n=n, row_ptr=row_ptr, col_idx=all_cols[order].astype(np.int32),
               val=all_vals[order])


def symmetric_full_csr(a_lower: CSR) -> CSR:
    """Full CSR of the symmetric matrix whose lower half is ``a_lower``."""
    low = to_scipy(a_lower).tocsr()
    d = low.diagonal()
    full = (low + low.T).tolil()
    full.setdiag(d)
    full = full.tocsr()
    full.sort_indices()
    return CSR(n=a_lower.n, row_ptr=full.indptr.astype(np.int64),
               col_idx=full.indices.astype(np.int32), val=full.data.astype(np.float64))


def matvec_lower(a_lower: CSR, v: np.ndarray) -> np.ndarray:
    """Host oracle: ``A v`` for symmetric A given its lower half (any RHS shape)."""
    import scipy.sparse as sp

    low = to_scipy(a_lower).tocsr()
    strict = low - sp.diags(low.diagonal())
    return low @ v + strict.T @ v


def ic0(a_lower: CSR) -> CSR:
    """Zero-fill incomplete Cholesky ``A ~= L L^T`` on ``a_lower``'s pattern.

    Up-looking row algorithm: entries are computed in row-major order, dropped
    outside the input pattern (that *is* the IC(0) approximation), and a small
    positive floor guards the pivot against indefinite breakdown (Manteuffel's
    classic failure mode for barely-SPD inputs).
    """
    n, rp, ci = a_lower.n, a_lower.row_ptr, a_lower.col_idx
    lvals = np.zeros(a_lower.nnz)
    # dense work row: zero outside the current row's pattern, so pattern
    # intersection in the inner dot is free (missing entries contribute 0)
    work = np.zeros(n)
    for i in range(n):
        s, e = int(rp[i]), int(rp[i + 1])
        cols = ci[s:e]
        assert cols[-1] == i, "rows must end at the diagonal"
        work[cols] = a_lower.val[s:e]
        for t in range(s, e - 1):
            j = int(ci[t])
            js, je = int(rp[j]), int(rp[j + 1])
            # L[i,j] = (A[i,j] - <row i prefix, row j of L>) / L[j,j]
            dot = np.dot(lvals[js:je - 1], work[ci[js:je - 1]])
            work[j] = (work[j] - dot) / lvals[je - 1]
        head = work[cols[:-1]]
        d = work[i] - np.dot(head, head)
        work[i] = np.sqrt(max(d, 1e-12))
        lvals[s:e] = work[cols]
        work[cols] = 0.0
    return CSR(n=n, row_ptr=rp.copy(), col_idx=ci.copy(), val=lvals)


def ilu0(a: CSR) -> tuple[CSR, CSR]:
    """Zero-fill ILU ``A ~= L U`` of a *full* square CSR (diagonal present).

    IKJ variant: returns unit-lower ``L`` (strictly-lower entries plus an
    explicit unit diagonal, so the triangular solver can consume it directly)
    and upper ``U`` including the diagonal.
    """
    n, rp, ci = a.n, a.row_ptr, a.col_idx
    v = a.val.astype(np.float64).copy()
    diag_ptr = np.empty(n, dtype=np.int64)
    for i in range(n):
        row = ci[rp[i]:rp[i + 1]]
        pos = np.searchsorted(row, i)
        assert pos < row.shape[0] and row[pos] == i, f"missing diagonal in row {i}"
        diag_ptr[i] = rp[i] + pos
    slot = np.full(n, -1, dtype=np.int64)  # column -> nnz slot of the current row
    for i in range(n):
        s, e = int(rp[i]), int(rp[i + 1])
        slot[ci[s:e]] = np.arange(s, e)
        for t in range(s, int(diag_ptr[i])):
            k = int(ci[t])
            # pivot row k < i completed earlier, so its diagonal has already
            # been breakdown-clamped below — never 0 here
            v[t] /= v[diag_ptr[k]]
            # eliminate with row k's upper part, dropped to row i's pattern
            for u in range(int(diag_ptr[k]) + 1, int(rp[k + 1])):
                p = slot[ci[u]]
                if p >= 0:
                    v[p] -= v[t] * v[u]
        slot[ci[s:e]] = -1
        if v[diag_ptr[i]] == 0.0:
            # breakdown guard, written back into U: the diagonal is final once
            # this row's elimination completes, and both later eliminations and
            # the U-triangular solve divide by it
            v[diag_ptr[i]] = 1e-12

    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    cols = ci.astype(np.int64)
    lm = rows > cols
    um = rows <= cols
    l_rows = np.concatenate([rows[lm], np.arange(n)])
    l_cols = np.concatenate([cols[lm], np.arange(n)])
    l_vals = np.concatenate([v[lm], np.ones(n)])
    order = np.lexsort((l_cols, l_rows))
    l_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(l_rows, minlength=n), out=l_ptr[1:])
    lower = CSR(n=n, row_ptr=l_ptr, col_idx=l_cols[order].astype(np.int32),
                val=l_vals[order])
    u_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[um], minlength=n), out=u_ptr[1:])
    upper = CSR(n=n, row_ptr=u_ptr, col_idx=cols[um].astype(np.int32), val=v[um])
    return lower, upper


def upper_as_reversed_lower(u: CSR) -> CSR:
    """U^T as CSR — the lower-triangular input the transpose-plan path needs to
    execute ``U x = y`` (``build_plan(csr_transpose(u), transpose=True)``)."""
    return csr_transpose(u)
