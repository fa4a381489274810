"""Block-op dispatch between the plain PyTorch ops and the CUDA kernels.

Backends (the reference package's names on the left):

* ``reference`` -> ``reference``: plain PyTorch (:mod:`repro_torch.kernels.ref`),
  the default when the caller chose the CPU.
* ``pallas``    -> ``cuda``: the hand-written Hopper kernels
  (:mod:`~repro_torch.kernels.block_trsv`, :mod:`~repro_torch.kernels.block_spmv`),
  the default on a CUDA device. Given CPU tensors, their wrappers run the
  plain versions, so the same code path is testable without a card.
* ``fused``     -> ``fused``: an *executor-level* backend. A single-device
  levelset or dagpart solve is one launch of the superstep megakernel
  (:mod:`~repro_torch.kernels.superstep`), which makes no per-op call:
  resident up to the stream limit, streamed above it
  (``core.solver.fused_streaming``); on CPU tensors its wrapper runs the
  plain version.
* ``fused_streamed`` -> ``fused_streamed``: the same, one launch of the
  streamed form, which copies each row's tiles from its own streamed store
  into shared memory by asynchronous bulk copies issued ahead of use.

A multi-device ``comm="unified"`` plan with a cut runs either fused backend
as one launch of the megakernel's split form per superstep
(``superstep_split``, ``superstep_streamed_split``), with the exchange
between launches.

Per-op calls (:func:`batched_block_trsv`, :func:`batched_block_gemv`) under
either fused backend run on the device's default backend
(:func:`op_backend`: the CUDA kernels on a card, the plain versions on the
CPU), as the reference's ``op_backend`` degrades them to its platform
default. The fused executor itself makes none; the Krylov SpMV and the
syncfree executor's frontier-bucketed form (which the fused backends select)
resolve their block ops the same way.

Every op accepts either a single right-hand side per tile (``(k, B)``) or a
multi-RHS panel (``(k, B, R)``) and dispatches on that rank.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.block_spmv import block_gemm, block_gemv, block_gemv_grouped
from repro_torch.kernels.block_trsv import block_trsm, block_trsv, block_trsv_panel
from repro_torch.kernels.superstep import (
    superstep_call, superstep_split_, superstep_streamed_call, superstep_streamed_split_,
)

BACKENDS = ("reference", "cuda", "fused", "fused_streamed")
FUSED_BACKENDS = ("fused", "fused_streamed")
TRSV_ALGORITHMS = ("rowsweep", "panel")
KERNELS = {"block_trsv": block_trsv, "block_trsm": block_trsm,
           "block_gemv": block_gemv, "block_gemm": block_gemm,
           "block_trsv_panel": block_trsv_panel, "block_gemv_grouped": block_gemv_grouped,
           "superstep": superstep_call, "superstep_streamed": superstep_streamed_call,
           "superstep_split": superstep_split_,
           "superstep_streamed_split": superstep_streamed_split_}


def executor_backend(backend: str | None, device: torch.device) -> str:
    """Resolve the executor-level backend: ``None`` means ``"cuda"`` on a
    CUDA device and ``"reference"`` on the CPU."""
    b = backend or ("cuda" if torch.device(device).type == "cuda" else "reference")
    if b not in BACKENDS:
        raise ValueError(f"unknown kernel backend: {b!r} (expected {BACKENDS})")
    return b


def op_backend(backend: str | None, device: torch.device) -> str:
    """Resolve the per-op backend: a fused backend maps to the device's
    default (``"cuda"`` on a card, ``"reference"`` on the CPU)."""
    b = executor_backend(backend, device)
    return executor_backend(None, device) if b in FUSED_BACKENDS else b


def bcast_trailing(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Reshape ``mask`` with trailing singleton dims so it broadcasts against
    ``x`` — lets solver code stay agnostic to single- vs multi-RHS shapes."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))


def batched_block_trsv(diag: torch.Tensor, rhs: torch.Tensor, *,
                       backend: str | None = None,
                       algorithm: str = "rowsweep") -> torch.Tensor:
    if algorithm not in TRSV_ALGORITHMS:
        raise ValueError(f"unknown block_trsv algorithm: {algorithm!r} "
                         f"(expected {TRSV_ALGORITHMS})")
    backend = op_backend(backend, diag.device)
    if backend == "reference":
        return ref.block_trsv_ref(diag, rhs)
    if rhs.ndim == 3:  # panels take the TRSM whatever the algorithm, as in the reference
        return block_trsm(diag, rhs)
    if algorithm == "panel":
        return block_trsv_panel(diag, rhs)
    return block_trsv(diag, rhs)


def batched_block_gemv(tiles: torch.Tensor, xs: torch.Tensor, *,
                       backend: str | None = None, group: int = 0) -> torch.Tensor:
    backend = op_backend(backend, tiles.device)
    if backend == "reference":
        return ref.block_gemv_ref(tiles, xs)
    if xs.ndim == 3:
        return block_gemm(tiles, xs)
    if group > 1:
        return block_gemv_grouped(tiles, xs, group)
    return block_gemv(tiles, xs)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
