"""Batched dense lower-triangular block solves: the CUDA row sweep, and the
panel forward substitution.

Wrappers over ``csrc/block_trsv.cu`` (which says what each kernel replaces,
what bounds it and how). A wrapper given CPU tensors returns the plain
version from :mod:`repro_torch.kernels.ref`; given CUDA tensors it launches
its kernel on the current stream or raises. ``launches`` on each wrapper
counts kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import extension, ref


def block_trsv(diag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """k independent B×B forward substitutions: (k,B,B), (k,B) -> (k,B)."""
    extension.check_operands("block_trsv", diag, rhs)
    if rhs.ndim != 2:
        raise ValueError(f"block_trsv: rhs must be (k,B), got {tuple(rhs.shape)}")
    if diag.device.type == "cpu":
        return ref.block_trsv_ref(diag, rhs)
    out = torch.empty_like(rhs)
    k, B = rhs.shape
    if k == 0 or B == 0:  # CUDA refuses an empty grid
        return out
    extension.launch("block_trsv", "repro_trsv_f32", diag.device,
                     diag.data_ptr(), rhs.data_ptr(), out.data_ptr(), k, B)
    block_trsv.launches += 1
    return out


def block_trsm(diag: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The same solve on R-column panels: (k,B,B), (k,B,R) -> (k,B,R)."""
    extension.check_operands("block_trsm", diag, rhs)
    if rhs.ndim != 3:
        raise ValueError(f"block_trsm: rhs must be (k,B,R), got {tuple(rhs.shape)}")
    if diag.device.type == "cpu":
        return ref.block_trsv_ref(diag, rhs)
    out = torch.empty_like(rhs)
    k, B, R = rhs.shape
    if k == 0 or B == 0 or R == 0:
        return out
    extension.launch("block_trsv", "repro_trsm_f32", diag.device,
                     diag.data_ptr(), rhs.data_ptr(), out.data_ptr(), k, B, R)
    block_trsm.launches += 1
    return out


def block_trsv_panel(diag: torch.Tensor, rhs: torch.Tensor, panel: int = 8) -> torch.Tensor:
    """The panel algorithm of the reference's ``block_trsv(algorithm="panel")``:
    (k,B,B), (k,B) -> (k,B), ``panel`` rows per step, ``B % panel == 0``.
    It sums in another order than :func:`block_trsv`, so the two agree
    within float32 rounding, not bit for bit; its kernel gives the bits of
    :func:`repro_torch.kernels.ref.panel_bits_ref` (B <= 32)."""
    extension.check_operands("block_trsv_panel", diag, rhs)
    if rhs.ndim != 2:
        raise ValueError(f"block_trsv_panel: rhs must be (k,B), got {tuple(rhs.shape)}")
    k, B = rhs.shape
    if panel < 1 or B % panel:
        raise ValueError(f"block_trsv_panel: block size {B} is not a multiple of panel {panel}")
    if diag.device.type == "cpu":
        return ref.block_trsv_panel_ref(diag, rhs, panel)
    out = torch.empty_like(rhs)
    if k == 0:  # CUDA refuses an empty grid
        return out
    extension.launch("block_trsv", "repro_trsv_panel_f32", diag.device,
                     diag.data_ptr(), rhs.data_ptr(), out.data_ptr(), k, B, panel)
    block_trsv_panel.launches += 1
    return out


block_trsv.launches = 0
block_trsm.launches = 0
block_trsv_panel.launches = 0
