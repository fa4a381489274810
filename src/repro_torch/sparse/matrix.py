"""Host-side sparse matrix containers for SpTRSV.

The paper stores ``L`` in CSC (``col_ptr, row_idx, val``) — we keep both CSC
(the paper's input format) and CSR (convenient for row-oriented analysis).
All arrays are numpy (host); the device-side solver consumes the dense-block
structure built in :mod:`repro_torch.core.blocking`.

Every matrix handled here is *unit-structured lower triangular*: square, all
diagonal entries present and nonzero, and no entries above the diagonal.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed sparse column lower-triangular matrix (paper's format)."""

    n: int
    col_ptr: np.ndarray  # (n+1,) int64
    row_idx: np.ndarray  # (nnz,) int32
    val: np.ndarray  # (nnz,) float

    @property
    def nnz(self) -> int:
        return int(self.col_ptr[-1])

    def validate(self) -> None:
        assert self.col_ptr.shape == (self.n + 1,)
        assert self.col_ptr[0] == 0
        assert self.row_idx.shape[0] == self.col_ptr[-1]
        if self.n == 0:  # degenerate: empty matrix is trivially valid
            return
        assert np.all(np.diff(self.col_ptr) >= 1), "missing diagonal"
        # every column starts at its diagonal entry ...
        starts = np.asarray(self.col_ptr[:-1], dtype=np.int64)
        assert np.array_equal(self.row_idx[starts], np.arange(self.n)), (
            "columns must start at the diagonal"
        )
        # ... and row indices ascend strictly within each column
        if self.nnz > 1:
            col_of = np.repeat(np.arange(self.n), np.diff(self.col_ptr))
            same_col = col_of[1:] == col_of[:-1]
            assert np.all(np.diff(self.row_idx)[same_col] > 0), (
                "row indices must ascend within each column"
            )


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row lower-triangular matrix."""

    n: int
    row_ptr: np.ndarray  # (n+1,) int64
    col_idx: np.ndarray  # (nnz,) int32
    val: np.ndarray  # (nnz,) float

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])

    def diagonal(self) -> np.ndarray:
        # Last entry of each row is the diagonal (col_idx sorted ascending, j <= i).
        return self.val[self.row_ptr[1:] - 1]


def csc_to_csr(a: CSC) -> CSR:
    n, nnz = a.n, a.nnz
    counts = np.bincount(a.row_idx, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    col_idx = np.empty(nnz, dtype=np.int32)
    val = np.empty(nnz, dtype=a.val.dtype)
    cols = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.col_ptr))
    # CSC visited column-major means row entries arrive with ascending column — stable fill.
    cursor = row_ptr[:-1].copy()
    order = np.argsort(a.row_idx, kind="stable")
    col_idx_sorted = cols[order]
    val_sorted = a.val[order]
    col_idx[:] = col_idx_sorted
    val[:] = val_sorted
    del cursor
    return CSR(n=n, row_ptr=row_ptr, col_idx=col_idx, val=val)


def csr_to_csc(a: CSR) -> CSC:
    n, nnz = a.n, a.nnz
    counts = np.bincount(a.col_idx, minlength=n)
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=col_ptr[1:])
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.row_ptr))
    order = np.argsort(a.col_idx, kind="stable")
    return CSC(n=n, col_ptr=col_ptr, row_idx=rows[order].astype(np.int32), val=a.val[order])


def lower_triangular_from_coo(
    n: int, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray | None = None,
    *, rng: np.random.Generator | None = None, diag_dominant: bool = True,
) -> CSR:
    """Build a well-conditioned lower-triangular CSR from strictly-lower COO pattern.

    Ensures: unique entries, full diagonal, strictly-lower ``cols < rows``; if
    ``diag_dominant`` the diagonal is ``1 + sum(|row|)`` so forward substitution
    is numerically benign (needed for float32 comparisons in tests/benches).
    """
    rng = rng or np.random.default_rng(0)
    mask = cols < rows
    rows, cols = rows[mask].astype(np.int64), cols[mask].astype(np.int64)
    key = rows * n + cols
    key, uniq_idx = np.unique(key, return_index=True)
    rows, cols = key // n, key % n
    if vals is None:
        vals = rng.uniform(-1.0, 1.0, size=rows.shape[0])
    else:
        vals = vals[mask][uniq_idx]
    # append diagonal
    all_rows = np.concatenate([rows, np.arange(n)])
    all_cols = np.concatenate([cols, np.arange(n)])
    row_abs_sum = np.zeros(n)
    np.add.at(row_abs_sum, rows, np.abs(vals))
    diag = (1.0 + row_abs_sum) if diag_dominant else rng.uniform(1.0, 2.0, size=n)
    all_vals = np.concatenate([vals, diag])
    order = np.lexsort((all_cols, all_rows))
    all_rows, all_cols, all_vals = all_rows[order], all_cols[order], all_vals[order]
    counts = np.bincount(all_rows, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return CSR(n=n, row_ptr=row_ptr, col_idx=all_cols.astype(np.int32), val=all_vals)


def csr_transpose(a: CSR) -> CSR:
    """CSR of A^T (a lower-triangular result when A is upper-triangular)."""
    c = csr_to_csc(a)
    return CSR(n=a.n, row_ptr=c.col_ptr.copy(), col_idx=c.row_idx.astype(np.int32),
               val=c.val.copy())


def reverse_transpose(a: CSR) -> CSR:
    """R with ``R[i, j] = A[n-1-j, n-1-i]`` (transpose + reverse both orders).

    For lower-triangular ``L`` this is again *lower*-triangular, and solving
    ``L^T x = y`` is exactly ``R (Px) = Py`` with ``P`` the index-reversal
    permutation — the trick that lets the forward-substitution solver execute
    upper-triangular/transpose solves (the IC(0)/ILU(0) backward sweeps).
    """
    n = a.n
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.row_ptr))
    cols = a.col_idx.astype(np.int64)
    nr, nc = n - 1 - cols, n - 1 - rows
    order = np.lexsort((nc, nr))
    nr, nc, v = nr[order], nc[order], a.val[order]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(nr, minlength=n), out=row_ptr[1:])
    return CSR(n=n, row_ptr=row_ptr, col_idx=nc.astype(np.int32), val=v)


def to_scipy(a: CSR):
    import scipy.sparse as sp

    return sp.csr_matrix((a.val, a.col_idx, a.row_ptr), shape=(a.n, a.n))


def reference_solve(a: CSR, b: np.ndarray) -> np.ndarray:
    """Ground-truth forward substitution via scipy (the correctness oracle)."""
    import scipy.sparse.linalg as spla

    return spla.spsolve_triangular(to_scipy(a).tocsr(), b, lower=True)
