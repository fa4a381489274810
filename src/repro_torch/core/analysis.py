"""Dependency analysis for SpTRSV (host side, numpy).

Mirrors the paper's two preprocessing flavours:
* ``in_degrees`` — the cheap O(nnz) counter pass used by the synchronization-free
  algorithm (paper §II-C / Alg. 2 lines 6–9, Alg. 3 lines 13–15);
* ``level_sets`` — the classical level-set (Naumov-style) analysis used by the
  level-scheduled baseline (paper §II-B, Fig. 1).

Also computes the paper's scalability metrics (§VI-D):
``dependency = nnz/n`` and ``parallelism = n/#levels``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.matrix import CSR


def in_degrees(a: CSR) -> np.ndarray:
    """Unfinished-dependency counters: off-diagonal nnz per row."""
    return (np.diff(a.row_ptr) - 1).astype(np.int32)


def level_of_rows(a: CSR) -> np.ndarray:
    """lvl[i] = 1 + max(lvl[j] : l_ij != 0, j < i), lvl = 0 for independent rows.

    Single ascending sweep (row i only references j < i). Vectorized per row
    via np.maximum.reduceat over the strictly-lower entries.
    """
    n = a.n
    lvl = np.zeros(n, dtype=np.int32)
    row_ptr, col_idx = a.row_ptr, a.col_idx
    for i in range(n):
        lo, hi = row_ptr[i], row_ptr[i + 1] - 1  # exclude diagonal (last in row)
        if hi > lo:
            lvl[i] = lvl[col_idx[lo:hi]].max() + 1
    return lvl


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    """Rows grouped by level: rows ``order[level_ptr[t]:level_ptr[t+1]]`` form level t."""

    n_levels: int
    level_ptr: np.ndarray  # (n_levels+1,)
    order: np.ndarray  # (n,) row ids sorted by level (stable)
    level_of: np.ndarray  # (n,)


def level_sets(a: CSR) -> LevelSchedule:
    lvl = level_of_rows(a)
    n_levels = int(lvl.max()) + 1 if a.n else 0
    order = np.argsort(lvl, kind="stable").astype(np.int32)
    counts = np.bincount(lvl, minlength=n_levels)
    level_ptr = np.zeros(n_levels + 1, dtype=np.int64)
    np.cumsum(counts, out=level_ptr[1:])
    return LevelSchedule(n_levels=n_levels, level_ptr=level_ptr, order=order, level_of=lvl)


@dataclasses.dataclass(frozen=True)
class MatrixMetrics:
    n: int
    nnz: int
    n_levels: int
    dependency: float  # nnz / n        (paper §VI-D)
    parallelism: float  # n / #levels   (paper §VI-D / Table I)


def metrics(a: CSR, sched: LevelSchedule | None = None) -> MatrixMetrics:
    sched = sched or level_sets(a)
    return MatrixMetrics(
        n=a.n,
        nnz=a.nnz,
        n_levels=sched.n_levels,
        dependency=a.nnz / max(1, a.n),
        parallelism=a.n / max(1, sched.n_levels),
    )
