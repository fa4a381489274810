"""Plain PyTorch versions of the four block kernels.

They are the CPU path of every kernel wrapper, the ``"reference"`` backend,
and what ``chip_smoke.py`` holds each CUDA kernel against on the card. They
call library routines (``torch.linalg.solve_triangular``, ``einsum``), so
nothing on the ``"cuda"`` backend's path calls them with a CUDA tensor.
"""
from __future__ import annotations

import torch


def block_trsv_ref(diag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched dense lower-triangular solve: ``diag`` (k,B,B) with a single
    right-hand side per tile ``(k,B)`` or an R-column panel ``(k,B,R)``."""
    multi = rhs.ndim == 3
    r = rhs if multi else rhs.unsqueeze(-1)
    sol = torch.linalg.solve_triangular(diag, r, upper=False)
    return sol if multi else sol.squeeze(-1)


def block_gemv_ref(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Batched tile products: tiles (m,B,B) with xs (m,B) or (m,B,R)."""
    if xs.ndim == 3:
        return torch.einsum("mij,mjr->mir", tiles, xs)
    return torch.einsum("mij,mj->mi", tiles, xs)
