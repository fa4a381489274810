"""Block-op cost weights per kernel backend and device.

``block_row_cost``'s analytic default says a B×B tile product costs 2× the
diagonal TRSV. The weights of the minimal multi-RHS cost model

    cost(row, R) = w_solve·R + Σ_tiles (w_tile_mem + w_tile_flop·R)

(normalized to ``w_solve = 1``) come, in order of precedence, from:

1. the calibration store (:mod:`repro_torch.obs.calibration`): weights
   fitted from measured probe solves on this device type, when there are
   enough samples for the backend and B;
2. on the card, :func:`measured_weights`: the per-op kernels timed with CUDA
   events at a batch wide enough to amortize launch cost (device time per
   tile of the TRSV, of the GEMV at R = 1 and of the GEMM at R = ``R_PROBE``),
   formed into the three weights as the reference forms its HLO counts.
   A timing that fails raises; it never turns into analytic weights;
3. on the CPU (the caller asked for it), :func:`analytic_weights`: the
   reference's fallback counts (flops plus bytes at a fixed balance), equal
   bit for bit to the reference's ``hlo_weights(B, "reference")``.

``w_tile_mem`` is the R-independent tile-load term (a GEMM panel amortizes
the tile fetch across all R systems), ``w_tile_flop`` the per-RHS slope,
fitted from the cost at R = 1 and R = ``R_PROBE``.
"""
from __future__ import annotations

import functools
import math

import torch

R_PROBE = 8  # panel width used to fit the per-RHS slope
# The reference model's fixed balance (one byte ≈ 4 flop-equivalents), kept
# so the CPU's analytic weights equal the reference's; a model constant, not
# a property of any chip. It also prices collective and bulk-copy bytes in
# the auto-tuner's modelled score.
FLOPS_PER_BYTE = 4.0
MEASURE_TILES = 4096  # tiles per timed call: the kernel, not its launch, sets the pace
MEASURE_CALLS = 50  # calls per timed window
MERGE_NARROW_ROWS = 8  # a "narrow" level carries at most ~this many typical rows


def merge_cost_threshold(weights: tuple = (1.0, 1.0, 1.0), R: int = 1) -> float:
    """Busiest-device cost below which a level counts as *narrow* for the
    DAG-partition merge pass (``sched="dagpart"``).

    A level whose critical device does less work than ``MERGE_NARROW_ROWS``
    typical block rows is launch-overhead-bound, so merging it into the
    neighbouring superstep wins. "Typical row" = one diagonal TRSV plus two
    tile products, priced by the same weights that drive the malleable
    placement.
    """
    w_solve, w_tile_mem, w_tile_flop = weights
    unit = w_solve * R + 2.0 * (w_tile_mem + w_tile_flop * R)
    return MERGE_NARROW_ROWS * max(float(unit), 1e-9)


def calibrate_weights(B: int = 32, backend: str | None = None, *, device=None,
                      feedback: bool = True) -> tuple:
    """(w_solve, w_tile_mem, w_tile_flop) for B×B tiles on ``backend`` and
    ``device`` (``None``: the card), normalized to w_solve = 1.

    Fitted weights from the calibration store take precedence (with
    ``feedback``); otherwise the card's :func:`measured_weights`, or on the
    CPU the :func:`analytic_weights`. Each path returns the same values
    until new samples arrive (the timings are cached per card)."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if feedback:
        from repro_torch.obs.calibration import fitted_weights

        w = fitted_weights(B, backend, dev)
        if w is not None:
            return w
    if dev.type == "cpu":
        return analytic_weights(B)
    return measured_weights(B, backend, dev)


def _term(flops: float, bytes_: float) -> float:
    return flops + FLOPS_PER_BYTE * bytes_


def _weights(t1: float, g1: float, gR: float) -> tuple:
    """The three weights from the costs of one TRSV, one GEMV (R = 1) and
    one GEMM (R = ``R_PROBE``) of a tile, as the reference forms them."""
    w_tile_flop = max(0.0, (gR - g1) / (R_PROBE - 1))
    w_tile_mem = max(0.0, g1 - w_tile_flop)
    return (1.0, w_tile_mem / t1, w_tile_flop / t1)


@functools.cache
def analytic_weights(B: int = 32) -> tuple:
    """The reference's fallback counts: a TRSV touches the triangle (B²
    flops), each product moves the full tile plus its in/out vectors, bytes
    priced at ``FLOPS_PER_BYTE``."""
    tile_bytes = B * B * 4
    t1 = _term(B * B, tile_bytes + 2 * B * 4)
    g1 = _term(2 * B * B, tile_bytes + 2 * B * 4)
    gR = _term(2 * B * B * R_PROBE, tile_bytes + 2 * B * R_PROBE * 4)
    return _weights(t1, g1, gR)


def measured_weights(B: int = 32, backend: str | None = None, device=None) -> tuple:
    """The weights from the per-op kernels' device time per tile on the
    card (:func:`measured_tile_ms`), formed as the reference forms its
    counts."""
    ms = measured_tile_ms(B, backend, device)
    return _weights(ms["trsv"], ms["gemv"], ms["gemm"])


def measured_tile_ms(B: int = 32, backend: str | None = None, device=None) -> dict:
    """Device ms per tile of ``batched_block_trsv``, and of
    ``batched_block_gemv`` at R = 1 (``"gemv"``) and R = ``R_PROBE``
    (``"gemm"``), each over ``MEASURE_CALLS`` calls on ``MEASURE_TILES``
    tiles (:func:`repro_torch.obs.timing.device_time_ms`). The fused
    backends time their per-op backend
    (:func:`repro_torch.kernels.ops.op_backend`). Cached per (B, per-op
    backend, card name). Raises unless every time is finite and positive."""
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measured weights time the card's kernels, not {dev}")
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return dict(_measured(int(B), ops.op_backend(backend, dev),
                          torch.cuda.get_device_name(idx), idx))


@functools.cache
def _measured(B: int, kb: str, card: str, index: int) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.obs.timing import device_time_ms

    dev = torch.device("cuda", index)
    gen = torch.Generator(device=dev).manual_seed(B)
    k = MEASURE_TILES

    def uniform(*shape):
        return torch.rand(*shape, device=dev, generator=gen) * 2 - 1

    diag = torch.tril(uniform(k, B, B), -1) / B + 2 * torch.eye(B, device=dev)
    tiles, vec, panel = uniform(k, B, B), uniform(k, B), uniform(k, B, R_PROBE)
    with torch.cuda.device(dev):
        ms = {name: device_time_ms(fn, MEASURE_CALLS) / k for name, fn in (
            ("trsv", lambda: ops.batched_block_trsv(diag, vec, backend=kb)),
            ("gemv", lambda: ops.batched_block_gemv(tiles, vec, backend=kb)),
            ("gemm", lambda: ops.batched_block_gemv(tiles, panel, backend=kb)))}
    if not all(math.isfinite(t) and t > 0 for t in ms.values()):
        raise RuntimeError(f"measured weights on {card}: per-tile ms {ms} are not all "
                           f"finite and positive")
    return ms
