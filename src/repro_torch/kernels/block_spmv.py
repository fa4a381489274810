"""Batched per-tile products for the off-diagonal updates: CUDA GEMV/GEMM.

Wrappers over ``csrc/block_spmv.cu`` (which says what each kernel replaces,
what bounds it and how). A wrapper given CPU tensors returns the plain
version from :mod:`repro_torch.kernels.ref`; given CUDA tensors it launches
its kernel on the current stream or raises. ``launches`` on each wrapper
counts kernel launches, and nothing else. The scatter-add of the products
into destination rows happens in the caller (``index_add_``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import extension, ref


def block_gemv(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Per-tile products: tiles (m,B,B) @ xs (m,B) -> (m,B)."""
    extension.check_operands("block_gemv", tiles, xs)
    if xs.ndim != 2:
        raise ValueError(f"block_gemv: xs must be (m,B), got {tuple(xs.shape)}")
    if tiles.device.type == "cpu":
        return ref.block_gemv_ref(tiles, xs)
    out = torch.empty_like(xs)
    m, B = xs.shape
    if m == 0 or B == 0:  # CUDA refuses an empty grid
        return out
    extension.launch("block_spmv", "repro_gemv_f32", tiles.device,
                     tiles.data_ptr(), xs.data_ptr(), out.data_ptr(), m, B)
    block_gemv.launches += 1
    return out


def block_gemm(tiles: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Multi-RHS tile products: tiles (m,B,B) @ xs (m,B,R) -> (m,B,R)."""
    extension.check_operands("block_gemm", tiles, xs)
    if xs.ndim != 3:
        raise ValueError(f"block_gemm: xs must be (m,B,R), got {tuple(xs.shape)}")
    if tiles.device.type == "cpu":
        return ref.block_gemv_ref(tiles, xs)
    out = torch.empty_like(xs)
    m, B, R = xs.shape
    if m == 0 or B == 0 or R == 0:
        return out
    extension.launch("block_spmv", "repro_gemm_f32", tiles.device,
                     tiles.data_ptr(), xs.data_ptr(), out.data_ptr(), m, B, R)
    block_gemm.launches += 1
    return out


def block_gemv_grouped(tiles: torch.Tensor, xs: torch.Tensor, group: int = 8) -> torch.Tensor:
    """:func:`block_gemv` with ``group`` tiles per CTA (the reference's
    ``block_gemv_grouped``): the same (m,B,B) @ (m,B) -> (m,B), bit for bit;
    the last group may be short (no padded copies)."""
    extension.check_operands("block_gemv_grouped", tiles, xs)
    if xs.ndim != 2:
        raise ValueError(f"block_gemv_grouped: xs must be (m,B), got {tuple(xs.shape)}")
    if group < 1:
        raise ValueError(f"block_gemv_grouped: group must be >= 1, got {group}")
    if tiles.device.type == "cpu":
        return ref.block_gemv_ref(tiles, xs)
    out = torch.empty_like(xs)
    m, B = xs.shape
    if m == 0 or B == 0:  # CUDA refuses an empty grid
        return out
    extension.launch("block_spmv", "repro_gemv_grouped_f32", tiles.device,
                     tiles.data_ptr(), xs.data_ptr(), out.data_ptr(), m, B, group)
    block_gemv_grouped.launches += 1
    return out


block_gemv.launches = 0
block_gemm.launches = 0
block_gemv_grouped.launches = 0
