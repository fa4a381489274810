"""Krylov + preconditioner subsystem: SpTRSV as the hot path of real
iterative solves."""
from repro_torch.krylov.api import (
    IC0Preconditioner,
    make_ic0_preconditioner,
    solve_cg,
    solve_ic0_pcg,
)
from repro_torch.krylov.cg import KrylovResult, pcg
from repro_torch.krylov.precond import (
    ic0,
    ilu0,
    matvec_lower,
    spd_lower_from_triangular,
    symmetric_full_csr,
    upper_as_reversed_lower,
)
from repro_torch.krylov.spmv import SpMV
