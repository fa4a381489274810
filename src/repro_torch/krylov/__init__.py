"""Krylov + preconditioner subsystem: SpTRSV as the hot path of real
iterative solves."""
from repro_torch.krylov.api import (
    IC0Preconditioner,
    ILU0Preconditioner,
    make_ic0_preconditioner,
    make_ilu0_preconditioner,
    solve_cg,
    solve_ic0_pcg,
    solve_ilu0_bicgstab,
)
from repro_torch.krylov.bicgstab import bicgstab
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
