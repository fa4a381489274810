"""Symmetric SpMV reusing the solver plan's tile stores.

The Krylov matvec ``y = A v`` runs on exactly the data the SpTRSV plan of
A's lower-triangular half already holds on the device:

* ``D_sym[r] @ v[r]``  for every block row (symmetrized diagonal tiles),
* ``L[r,c] @ v[c]``    for every stored tile (scattered to row ``r``),
* ``L[r,c]^T @ v[r]``  the mirrored upper entries (scattered to ``c``).

The products go through the block GEMV/GEMM kernels (rank dispatch in
:mod:`repro_torch.kernels.ops`), the scatters through ``index_add_``.

On a ``torch.distributed`` group of D ranks (the plan's ``n_devices``), each
rank holds its own device's tiles and counts the diagonal blocks of the
rows it owns; one ``all_reduce(SUM)`` a matvec (the reference's ``psum``)
gives every rank the whole ``y``, the same bits on each.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.blocking import pad_rhs, unpad_x
from repro_torch.core.solver import Plan, check_executable
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def _symmetrize_diag(diag: np.ndarray) -> np.ndarray:
    """(nb+1,B,B) lower-triangular diagonal tiles -> full symmetric tiles."""
    dvals = np.einsum("kii->ki", diag)
    sym = diag + diag.transpose(0, 2, 1)
    _, b, _ = diag.shape
    sym[:, np.arange(b), np.arange(b)] = dvals
    return sym.astype(np.float32)


class SpMV:
    """``y = A v`` for symmetric A given the plan of its lower half.

    ``group``: the ``torch.distributed`` group of a multi-device plan, one
    rank per device (a D-device plan without a group of D ranks raises
    ``ValueError``). ``n_matvecs`` counts calls; ``exchanges`` the
    ``all_reduce`` calls (one a matvec with a group, else none)."""

    def __init__(self, plan: Plan, device: str | torch.device | None = None, group=None):
        if plan.transpose:
            raise ValueError("SpMV needs the plan of A itself, not a transpose plan")
        self.rank = check_executable(plan, group)
        self.group = group
        self.plan = plan
        self.device = resolve_device(device)
        # a fused plan's solves are megakernel launches; its matvec keeps the
        # per-tile GEMV kernels
        self.backend = ops.op_backend(plan.config.kernel_backend, self.device)
        self.n_matvecs = self.exchanges = 0
        nb, r = plan.bs.nb, self.rank

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        self._tiles = dev(plan.tiles[r])
        self._tiles_t = dev(plan.tiles[r].transpose(0, 2, 1))
        self._trow = dev(plan.tile_row[r].astype(np.int64))
        self._tcol = dev(plan.tile_col[r].astype(np.int64))
        owner_mask = np.zeros(nb + 1, np.float32)  # the pad row adds nothing
        owner_mask[:nb] = plan.part.owner == r  # each diagonal block counted once
        self._owner_mask = dev(owner_mask)
        self._sym_diag = dev(_symmetrize_diag(plan.diag))

    def matvec_blocks(self, v_blocks: torch.Tensor) -> torch.Tensor:
        """v_blocks: (nb, B) or (nb, B, R) -> same shape."""
        self.n_matvecs += 1
        v = v_blocks.to(self.device, torch.float32)
        v_pad = torch.cat([v, v.new_zeros((1,) + v.shape[1:])])
        y = ops.batched_block_gemv(self._sym_diag, v_pad, backend=self.backend)
        y = y * ops.bcast_trailing(self._owner_mask, y)
        prods = ops.batched_block_gemv(self._tiles, v_pad[self._tcol],
                                       backend=self.backend)
        y.index_add_(0, self._trow, prods)  # pad tiles are zero -> inert
        mirrored = ops.batched_block_gemv(self._tiles_t, v_pad[self._trow],
                                          backend=self.backend)
        y.index_add_(0, self._tcol, mirrored)
        y = y[: self.plan.bs.nb]
        if self.group is not None:
            comm.all_reduce_sum_(y, self.group)
            self.exchanges += 1
        return y

    def matvec(self, v: np.ndarray) -> np.ndarray:
        """v: (n,) or (n, R) -> A v, same shape, as numpy."""
        v_blocks = torch.from_numpy(pad_rhs(np.asarray(v, np.float32), self.plan.bs))
        return unpad_x(self.matvec_blocks(v_blocks).cpu().numpy(), self.plan.bs)
