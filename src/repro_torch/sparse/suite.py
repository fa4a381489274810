"""Synthetic matrix suite matched to the paper's Table I signatures.

SuiteSparse is unavailable offline, so each test matrix is generated to match
the *structural signature* that drives SpTRSV behaviour (paper §VI-D):

* ``dependency``  = nnz / n            (avg nonzeros per component)
* ``parallelism`` = n / #levels        (avg components solvable per level)

The paper's matrices span 3 regimes: chain-dominated (many levels, tiny
parallelism: chipcool0, pkustk14, shipsec1), balanced (belgium_osm,
delaunay_n20, roadNet-CA, webbase-1M, dblp-2010), and embarrassingly parallel
(nlpkkt160 with 2 levels, dc2, powersim, Wordnet3). Generators below hit a
target (n, avg_deps, #levels) signature; sizes are scaled down with ``scale``
to stay CPU-friendly while preserving the level/parallelism shape.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.matrix import CSR, lower_triangular_from_coo


def random_levelled(
    n: int, levels: int, avg_deps: float, *, seed: int = 0, locality: float = 0.0
) -> CSR:
    """Lower-triangular matrix with ~``levels`` level-sets and ``avg_deps`` nnz/row.

    Rows are assigned to levels round-robin; each row in level t draws one
    mandatory parent from level t-1 (pins the level count) plus Poisson extras
    from any earlier row. ``locality`` in [0,1) biases extra parents toward
    nearby rows (models banded factors like pkustk14/shipsec1).
    """
    rng = np.random.default_rng(seed)
    levels = max(1, min(levels, n))
    lvl = np.arange(n) % levels  # row i sits in level (i % levels)
    # A row's parents must come from strictly earlier rows; to make lvl the true
    # level, row i needs a parent in the previous level with smaller index.
    rows_l, cols_l = [], []
    extra = max(0.0, avg_deps - 2.0)  # -1 diag, -1 mandatory parent
    for i in range(n):
        if lvl[i] == 0:
            continue
        # mandatory parent: most recent row of level lvl[i]-1 before i
        p = i - 1  # row i-1 always has level lvl[i]-1 given round-robin assignment
        rows_l.append(i)
        cols_l.append(p)
        k = rng.poisson(extra)
        if k and i > 1:
            if locality > 0.0:
                span = max(2, int((1.0 - locality) * i))
                lo = max(0, i - span)
                cand = rng.integers(lo, i, size=k)
            else:
                cand = rng.integers(0, i, size=k)
            # keep the level structure exact: extra parents only from earlier levels
            cand = cand[(cand % levels) < lvl[i]]
            rows_l.extend([i] * cand.shape[0])
            cols_l.extend(cand.tolist())
    rows = np.asarray(rows_l, dtype=np.int64)
    cols = np.asarray(cols_l, dtype=np.int64)
    return lower_triangular_from_coo(n, rows, cols, rng=rng)


def block_diagonal_parallel(n: int, n_blocks: int, avg_deps: float, *, seed: int = 0) -> CSR:
    """nlpkkt160-like: independent diagonal blocks -> ~2 levels, huge parallelism."""
    rng = np.random.default_rng(seed)
    bs = max(2, n // n_blocks)
    rows_l, cols_l = [], []
    for i in range(n):
        base = (i // bs) * bs
        k = rng.poisson(max(0.0, avg_deps - 1.0))
        if i > base and k:
            cand = rng.integers(base, i, size=k)
            rows_l.extend([i] * k)
            cols_l.extend(cand.tolist())
    return lower_triangular_from_coo(
        n, np.asarray(rows_l, dtype=np.int64), np.asarray(cols_l, dtype=np.int64), rng=rng
    )


def chain(n: int, *, seed: int = 0) -> CSR:
    """Bidiagonal worst case: n levels, parallelism 1 (pure dependency chain)."""
    rows = np.arange(1, n, dtype=np.int64)
    cols = rows - 1
    return lower_triangular_from_coo(n, rows, cols, rng=np.random.default_rng(seed))


def grid2d_factor(side: int, *, seed: int = 0) -> CSR:
    """Structure of an IC(0)-style factor of a 2D 5-point Laplacian (side*side rows).

    Mimics structured-grid problems (roadNet / delaunay regime): bandwidth
    ``side``, levels ~ O(side), parallelism ~ O(side).
    """
    n = side * side
    i = np.arange(n, dtype=np.int64)
    west = i - 1
    north = i - side
    rows = np.concatenate([i[i % side != 0], i[i >= side]])
    cols = np.concatenate([west[i % side != 0], north[i >= side]])
    return lower_triangular_from_coo(n, rows, cols, rng=np.random.default_rng(seed))


@dataclasses.dataclass(frozen=True)
class SuiteEntry:
    name: str
    build: object  # () -> CSR
    paper_levels: int
    paper_parallelism: float


def table1_suite(scale: float = 1.0) -> list[SuiteEntry]:
    """The 14-matrix Table-I analogue, structurally matched and CPU-scaled."""

    def S(x: int) -> int:
        return max(64, int(x * scale))

    entries = [
        # name                  generator                                        levels  par
        SuiteEntry("belgium_osm", lambda: random_levelled(S(14000), 128, 2.1, seed=1), 631, 2284),
        SuiteEntry("chipcool0", lambda: random_levelled(S(8000), 256, 7.5, seed=2, locality=0.9), 534, 38),
        SuiteEntry("citationCiteseer", lambda: random_levelled(S(12000), 48, 5.3, seed=3), 102, 2632),
        SuiteEntry("dblp-2010", lambda: random_levelled(S(10000), 384, 3.5, seed=4, locality=0.5), 1562, 209),
        SuiteEntry("dc2", lambda: block_diagonal_parallel(S(12000), 96, 3.8, seed=5), 14, 8345),
        SuiteEntry("delaunay_n20", lambda: grid2d_factor(int(np.sqrt(S(16000))), seed=6), 788, 1331),
        SuiteEntry("nlpkkt160", lambda: random_levelled(S(16000), 2, 14.0, seed=7), 2, 4172800),
        SuiteEntry("pkustk14", lambda: random_levelled(S(8000), 512, 49.0, seed=8, locality=0.95), 1075, 141),
        SuiteEntry("powersim", lambda: block_diagonal_parallel(S(6000), 48, 2.6, seed=9), 24, 660),
        SuiteEntry("roadNet-CA", lambda: grid2d_factor(int(np.sqrt(S(14000))), seed=10), 364, 5416),
        SuiteEntry("webbase-1M", lambda: random_levelled(S(12000), 96, 2.3, seed=11), 512, 1953),
        SuiteEntry("Wordnet3", lambda: random_levelled(S(10000), 16, 2.1, seed=12), 37, 2234),
        SuiteEntry("shipsec1", lambda: random_levelled(S(8000), 320, 6.0, seed=13, locality=0.9), 2100, 67),
        SuiteEntry("copter2", lambda: random_levelled(S(8000), 64, 4.4, seed=14), 190, 291),
    ]
    return entries
