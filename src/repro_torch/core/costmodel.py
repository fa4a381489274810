"""Block-op cost arithmetic shared by the partitioner and the merge pass.

Only the pure-arithmetic half of the reference cost model lives here. Weight
calibration (measured per kernel backend) is not ported yet, so every caller
uses explicit weights or the analytic defaults ``(1, 1, 1)``.
"""
from __future__ import annotations

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
